"""Native COCO index + COCOeval (bbox/segm) — no pycocotools dependency.

The reference's only integration gate is COCOeval AP on coco_2014_minival
(reference ``lib/utils/json_dataset_evaluator.py:116-125,193-202`` and
``README.md:22-32``). pycocotools is unavailable in this environment, so this
module implements the COCO dataset index and the standard COCOeval matching/
accumulation/summarisation algorithm natively on numpy, following the
published evaluation protocol (IoU thresholds 0.5:0.05:0.95, 101-point
interpolated precision, area ranges, maxDets 1/10/100, crowd-ignore
matching semantics).

The port's own copy of ``detectorch_tpu/eval/coco_eval.py``, held to it by
tests/test_torch_host_copies.py.
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from detectorch_tpu_torch.eval import rle as rle_mod


def _xywh_box_iou(dt: np.ndarray, gt: np.ndarray, iscrowd: Sequence[bool]) -> np.ndarray:
    """(D, G) IoU of xywh boxes, crowd gt uses dt-area denominator
    (pycocotools bbIou semantics — note: NO +1 convention here)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dt = np.asarray(dt, np.float64)
    gt = np.asarray(gt, np.float64)
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.maximum(
        0.0, np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :])
    )
    ih = np.maximum(
        0.0, np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :])
    )
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / union, 0.0)


class COCO:
    """Minimal COCO json index (images/annotations/categories)."""

    def __init__(self, annotation_file: Optional[str] = None, dataset: Optional[dict] = None):
        self.dataset = dataset or {}
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        if self.dataset:
            self._index()

    def _index(self):
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs.keys())

    def get_cat_ids(self) -> List[int]:
        return sorted(self.cats.keys())

    def load_anns_for_image(self, img_id: int) -> List[dict]:
        return self.img_to_anns.get(img_id, [])

    def ann_to_rle(self, ann: dict) -> rle_mod.RLE:
        img = self.imgs[ann["image_id"]]
        return rle_mod.segmentation_to_rle(
            ann["segmentation"], img["height"], img["width"]
        )

    def load_res(self, results) -> "COCO":
        """Build a results COCO from a list of result dicts (or a json path).
        Mirrors pycocotools COCO.loadRes: fills id/area/bbox fields."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        res = COCO()
        res.dataset = {
            "images": list(self.dataset.get("images", [])),
            "categories": copy.deepcopy(self.dataset.get("categories", [])),
            "annotations": [],
        }
        anns = copy.deepcopy(results)
        for i, ann in enumerate(anns):
            ann["id"] = i + 1
            if "segmentation" in ann and "bbox" not in ann:
                ann["bbox"] = rle_mod.to_bbox(ann["segmentation"]).tolist()
            if "keypoints" in ann and "bbox" not in ann:
                # pycocotools loadRes: bbox/area from the keypoint extent
                kp = np.asarray(ann["keypoints"], np.float64)
                xs, ys = kp[0::3], kp[1::3]
                x0, x1 = float(xs.min()), float(xs.max())
                y0, y1 = float(ys.min()), float(ys.max())
                ann["bbox"] = [x0, y0, x1 - x0, y1 - y0]
                ann["area"] = (x1 - x0) * (y1 - y0)
            if "area" not in ann:
                if "segmentation" in ann:
                    ann["area"] = rle_mod.area(ann["segmentation"])
                else:
                    ann["area"] = float(ann["bbox"][2] * ann["bbox"][3])
            ann.setdefault("iscrowd", 0)
        res.dataset["annotations"] = anns
        res._index()
        return res


def evaluate_box_proposals(
    proposals_per_image,
    gt_boxes_per_image,
    thresholds=None,
    area: str = "all",
    limit: int = 1000,
    gt_seg_areas_per_image=None,
):
    """Proposal recall / AR evaluator — exact semantics of the reference's
    json_dataset_evaluator.py:238-321 (executed as the oracle in
    tests/test_reference_oracles.py):

    - area binning uses the annotation ('seg') areas when
      ``gt_seg_areas_per_image`` is given (the reference reads
      entry['seg_areas']); falls back to +1-convention box areas
    - bounds are inclusive on both ends (``lo <= a <= hi``)
    - all eight Detectron area bins, including the 96-128 … 512-inf splits
    - recall denominator is ``num_pos`` (every in-range gt, including those
      in images that contributed no proposals)

    proposals_per_image: list of (N_i, 4) xyxy arrays (ranked);
    gt_boxes_per_image: list of (G_i, 4) xyxy non-crowd gt arrays.
    Returns dict with 'ar', 'recalls', 'thresholds', 'gt_overlaps',
    'num_pos'.
    """
    areas = {
        "all": (0.0 ** 2, 1e5 ** 2),
        "small": (0.0 ** 2, 32 ** 2),
        "medium": (32 ** 2, 96 ** 2),
        "large": (96 ** 2, 1e5 ** 2),
        "96-128": (96 ** 2, 128 ** 2),
        "128-256": (128 ** 2, 256 ** 2),
        "256-512": (256 ** 2, 512 ** 2),
        "512-inf": (512 ** 2, 1e5 ** 2),
    }
    a_lo, a_hi = areas[area]
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
    if gt_seg_areas_per_image is None:
        gt_seg_areas_per_image = [None] * len(gt_boxes_per_image)
    gt_overlaps = []
    num_pos = 0
    for props, gts, seg_areas in zip(
        proposals_per_image, gt_boxes_per_image, gt_seg_areas_per_image
    ):
        gts = np.asarray(gts, np.float64).reshape(-1, 4)
        if seg_areas is not None:
            ar = np.asarray(seg_areas, np.float64).reshape(-1)
        else:
            ar = (gts[:, 2] - gts[:, 0] + 1) * (gts[:, 3] - gts[:, 1] + 1)
        keep = (ar >= a_lo) & (ar <= a_hi)
        gts = gts[keep]
        num_pos += int(keep.sum())
        props = np.asarray(props, np.float64).reshape(-1, 4)
        if limit is not None:
            props = props[:limit]
        if len(gts) == 0 or len(props) == 0:
            continue
        # +1-convention IoU matrix (cython_bbox semantics, float64)
        pa = (props[:, 2] - props[:, 0] + 1) * (props[:, 3] - props[:, 1] + 1)
        ga = (gts[:, 2] - gts[:, 0] + 1) * (gts[:, 3] - gts[:, 1] + 1)
        iw = np.maximum(
            0,
            np.minimum(props[:, None, 2], gts[None, :, 2])
            - np.maximum(props[:, None, 0], gts[None, :, 0]) + 1,
        )
        ih = np.maximum(
            0,
            np.minimum(props[:, None, 3], gts[None, :, 3])
            - np.maximum(props[:, None, 1], gts[None, :, 1]) + 1,
        )
        inter = iw * ih
        overlaps = inter / (pa[:, None] + ga[None, :] - inter)
        # greedy one-to-one assignment, best pair first (reference :287-303)
        _gt_ov = np.zeros(len(gts))
        ov = overlaps.copy()
        for _ in range(min(len(props), len(gts))):
            argmax_overlaps = ov.argmax(axis=0)
            max_overlaps = ov.max(axis=0)
            gt_ind = max_overlaps.argmax()
            gt_ovr = max_overlaps.max()
            if gt_ovr < 0:
                break
            box_ind = argmax_overlaps[gt_ind]
            _gt_ov[gt_ind] = overlaps[box_ind, gt_ind]
            ov[box_ind, :] = -1
            ov[:, gt_ind] = -1
        gt_overlaps.append(_gt_ov)
    gt_overlaps = (
        np.concatenate(gt_overlaps) if gt_overlaps else np.zeros(0)
    )
    gt_overlaps = np.sort(gt_overlaps)
    # reference :315-318 — denominator is num_pos, NOT len(gt_overlaps):
    # gts in images with zero proposals count as misses
    recalls = np.array([
        float((gt_overlaps >= t).sum()) / num_pos if num_pos else 0.0
        for t in thresholds
    ])
    return {
        "ar": float(recalls.mean()),
        "recalls": recalls,
        "thresholds": thresholds,
        "num_pos": num_pos,
        "gt_overlaps": gt_overlaps,
    }


# COCO person-keypoint OKS falloff constants (pycocotools computeOks)
KPT_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89]
) / 10.0


def _compute_oks(dts, gts, sigmas=KPT_SIGMAS):
    """(D, G) OKS matrix (pycocotools computeOks semantics)."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    variances = (sigmas * 2) ** 2
    k = len(sigmas)
    out = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int(np.count_nonzero(vg > 0))
        bb = gt["bbox"]
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for i, dt in enumerate(dts):
            d = np.asarray(dt["keypoints"], np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx = xd - xg
                dy = yd - yg
            else:
                dx = np.maximum(x0 - xd, 0) + np.maximum(xd - x1, 0)
                dy = np.maximum(y0 - yd, 0) + np.maximum(yd - y1, 0)
            e = (dx ** 2 + dy ** 2) / variances / (gt["area"] + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            out[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] else 0.0
    return out


class COCOeval:
    """Standard COCO detection evaluation (bbox | segm | keypoints)."""

    def __init__(self, coco_gt: COCO, coco_dt: COCO, iou_type: str = "bbox"):
        assert iou_type in ("bbox", "segm", "keypoints")
        self.coco_gt = coco_gt
        self.coco_dt = coco_dt
        self.iou_type = iou_type
        self.iou_thrs = np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        if iou_type == "keypoints":
            self.max_dets = [20]
            self.area_rng = [
                [0.0, 1e5 ** 2], [32 ** 2, 96 ** 2], [96 ** 2, 1e5 ** 2]
            ]
            self.area_lbl = ["all", "medium", "large"]
        else:
            self.max_dets = [1, 10, 100]
            self.area_rng = [
                [0.0, 1e5 ** 2],
                [0.0, 32 ** 2],
                [32 ** 2, 96 ** 2],
                [96 ** 2, 1e5 ** 2],
            ]
            self.area_lbl = ["all", "small", "medium", "large"]
        self.img_ids = coco_gt.get_img_ids()
        self.cat_ids = coco_gt.get_cat_ids()
        self.eval_imgs = {}
        self.eval = None
        self.stats = np.zeros(12)

    # -- per-image-category ------------------------------------------------

    def _prepare(self):
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for img_id in self.img_ids:
            for ann in self.coco_gt.load_anns_for_image(img_id):
                ann = dict(ann)
                ann["ignore"] = ann.get("ignore", 0) or ann.get("iscrowd", 0)
                if self.iou_type == "keypoints":
                    ann["ignore"] = ann["ignore"] or ann.get("num_keypoints", 0) == 0
                if self.iou_type == "segm":
                    ann["_rle"] = self.coco_gt.ann_to_rle(ann)
                self._gts[(img_id, ann["category_id"])].append(ann)
            for ann in self.coco_dt.load_anns_for_image(img_id):
                ann = dict(ann)
                if self.iou_type == "segm":
                    ann["_rle"] = ann["segmentation"]
                self._dts[(img_id, ann["category_id"])].append(ann)

    def _compute_iou(self, img_id, cat_id):
        gts = self._gts[(img_id, cat_id)]
        dts = self._dts[(img_id, cat_id)]
        if len(gts) == 0 or len(dts) == 0:
            return np.zeros((len(dts), len(gts)))
        inds = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[i] for i in inds[: self.max_dets[-1]]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gts]
        if self.iou_type == "bbox":
            return _xywh_box_iou(
                [d["bbox"] for d in dts], [g["bbox"] for g in gts], iscrowd
            )
        if self.iou_type == "keypoints":
            return _compute_oks(dts, gts)
        return rle_mod.rle_iou([d["_rle"] for d in dts], [g["_rle"] for g in gts], iscrowd)

    def _evaluate_img(self, img_id, cat_id, a_rng, max_det, ious):
        gts = self._gts[(img_id, cat_id)]
        dts = self._dts[(img_id, cat_id)]
        if len(gts) == 0 and len(dts) == 0:
            return None
        for g in gts:
            g["_ignore"] = 1 if (g["ignore"] or g["area"] < a_rng[0] or g["area"] > a_rng[1]) else 0
        gt_ind = np.argsort([g["_ignore"] for g in gts], kind="mergesort")
        gts = [gts[i] for i in gt_ind]
        dt_ind = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[i] for i in dt_ind[:max_det]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gts]
        sub_ious = ious[:, gt_ind] if len(ious) > 0 else ious

        T = len(self.iou_thrs)
        G = len(gts)
        D = len(dts)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gt_ig = np.array([g["_ignore"] for g in gts])
        dt_ig = np.zeros((T, D))
        if G and D:
            for tind, t in enumerate(self.iou_thrs):
                for dind in range(D):
                    iou = min(t, 1 - 1e-10)
                    m = -1
                    for gind in range(G):
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        # gts sorted ignore-last: stop at first ignore once matched
                        if m > -1 and gt_ig[m] == 0 and gt_ig[gind] == 1:
                            break
                        if sub_ious[dind, gind] < iou:
                            continue
                        iou = sub_ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dt_ig[tind, dind] = gt_ig[m]
                    dtm[tind, dind] = gts[m]["id"]
                    gtm[tind, m] = dts[dind]["id"]
        # unmatched dts outside the area range are ignored
        a = np.array(
            [d["area"] < a_rng[0] or d["area"] > a_rng[1] for d in dts]
        ).reshape(1, D)
        dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0, np.repeat(a, T, axis=0)))
        return {
            "dtMatches": dtm,
            "dtScores": [d["score"] for d in dts],
            "gtIgnore": gt_ig,
            "dtIgnore": dt_ig,
        }

    # -- driver ------------------------------------------------------------

    def evaluate(self):
        self._prepare()
        self.ious = {
            (img_id, cat_id): self._compute_iou(img_id, cat_id)
            for img_id in self.img_ids
            for cat_id in self.cat_ids
        }
        max_det = self.max_dets[-1]
        self.eval_imgs = {
            (img_id, cat_id, tuple(a_rng)): self._evaluate_img(
                img_id, cat_id, a_rng, max_det, self.ious[(img_id, cat_id)]
            )
            for cat_id in self.cat_ids
            for a_rng in self.area_rng
            for img_id in self.img_ids
        }

    def accumulate(self):
        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        K = len(self.cat_ids)
        A = len(self.area_rng)
        M = len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for k, cat_id in enumerate(self.cat_ids):
            for a, a_rng in enumerate(self.area_rng):
                E = [
                    self.eval_imgs.get((img_id, cat_id, tuple(a_rng)))
                    for img_id in self.img_ids
                ]
                E = [e for e in E if e is not None]
                if not E:
                    continue
                for m, max_det in enumerate(self.max_dets):
                    dt_scores = np.concatenate(
                        [np.asarray(e["dtScores"])[:max_det] for e in E]
                    )
                    inds = np.argsort(-dt_scores, kind="mergesort")
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :max_det] for e in E], axis=1
                    )[:, inds]
                    dt_ig = np.concatenate(
                        [e["dtIgnore"][:, :max_det] for e in E], axis=1
                    )[:, inds]
                    gt_ig = np.concatenate([e["gtIgnore"] for e in E])
                    npig = int(np.count_nonzero(gt_ig == 0))
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dt_ig))
                    fps = np.logical_and(
                        np.logical_not(dtm), np.logical_not(dt_ig)
                    )
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp = tp_sum[t]
                        fp = fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0.0
                        q = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, self.rec_thrs, side="left")
                        for ri, pi in enumerate(inds_r):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[t, :, k, a, m] = q
        self.eval = {"precision": precision, "recall": recall}

    def _summarize(self, ap=1, iou_thr=None, area="all", max_dets=100):
        a = self.area_lbl.index(area)
        m = self.max_dets.index(max_dets)
        if ap:
            s = self.eval["precision"]
            if iou_thr is not None:
                t = int(np.where(np.isclose(self.iou_thrs, iou_thr))[0][0])
                s = s[[t]]
            s = s[:, :, :, a, m]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                t = int(np.where(np.isclose(self.iou_thrs, iou_thr))[0][0])
                s = s[[t]]
            s = s[:, :, a, m]
        vals = s[s > -1]
        return float(np.mean(vals)) if vals.size else -1.0

    def summarize(self, verbose: bool = True):
        if self.iou_type == "keypoints":
            st = np.zeros(10)
            st[0] = self._summarize(1, max_dets=20)
            st[1] = self._summarize(1, iou_thr=0.5, max_dets=20)
            st[2] = self._summarize(1, iou_thr=0.75, max_dets=20)
            st[3] = self._summarize(1, area="medium", max_dets=20)
            st[4] = self._summarize(1, area="large", max_dets=20)
            st[5] = self._summarize(0, max_dets=20)
            st[6] = self._summarize(0, iou_thr=0.5, max_dets=20)
            st[7] = self._summarize(0, iou_thr=0.75, max_dets=20)
            st[8] = self._summarize(0, area="medium", max_dets=20)
            st[9] = self._summarize(0, area="large", max_dets=20)
            self.stats = st
            if verbose:
                names = ["AP", "AP50", "AP75", "APm", "APl",
                         "AR", "AR50", "AR75", "ARm", "ARl"]
                for n, v in zip(names, st):
                    print(f"  {n:6s} = {v:.3f}")
            return st
        st = np.zeros(12)
        st[0] = self._summarize(1)
        st[1] = self._summarize(1, iou_thr=0.5)
        st[2] = self._summarize(1, iou_thr=0.75)
        st[3] = self._summarize(1, area="small")
        st[4] = self._summarize(1, area="medium")
        st[5] = self._summarize(1, area="large")
        st[6] = self._summarize(0, max_dets=1)
        st[7] = self._summarize(0, max_dets=10)
        st[8] = self._summarize(0, max_dets=100)
        st[9] = self._summarize(0, area="small")
        st[10] = self._summarize(0, area="medium")
        st[11] = self._summarize(0, area="large")
        self.stats = st
        if verbose:
            names = [
                "AP", "AP50", "AP75", "APs", "APm", "APl",
                "AR1", "AR10", "AR100", "ARs", "ARm", "ARl",
            ]
            for n, v in zip(names, st):
                print(f"  {n:6s} = {v:.3f}")
        return st

"""COCO dataset + roidb construction (host side).

Reference: ``lib/data/json_dataset.py`` (JsonDataset/get_roidb, proposal file
loading, crowd filtering, class assignment) and ``lib/data/roidb.py``
(roidb_for_training: flipped entries, filtering, bbox targets). Built on the
native COCO index in ``eval/coco_eval.py`` — no pycocotools.

Unlike the reference (torch Dataset + DataLoader worker processes +
variable-shape list collation), samples here are *fixed-shape* numpy
structures ready for device transfer: images padded to shape buckets,
proposals padded to a static count with validity masks.

The port's own copy of ``detectorch_tpu/data/coco.py``, held to it by
tests/test_torch_host_copies.py: the same code, keypoint annotations
included, with the port's imports.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from detectorch_tpu_torch.eval import rle as rle_mod
from detectorch_tpu_torch.eval.coco_eval import COCO


def _np_bbox_overlaps(boxes, query):
    """+1-convention IoU (reference cython_bbox semantics) in numpy.
    Computed in float64 exactly like the Cython kernel (cython_bbox.pyx
    DTYPE = np.float); callers that store the result into float32 buffers
    round at the same place the reference does."""
    if len(boxes) == 0 or len(query) == 0:
        return np.zeros((len(boxes), len(query)), np.float64)
    b = np.asarray(boxes, np.float64)
    q = np.asarray(query, np.float64)
    area_q = (q[:, 2] - q[:, 0] + 1) * (q[:, 3] - q[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    iw = np.maximum(
        0,
        np.minimum(b[:, None, 2], q[None, :, 2])
        - np.maximum(b[:, None, 0], q[None, :, 0]) + 1,
    )
    ih = np.maximum(
        0,
        np.minimum(b[:, None, 3], q[None, :, 3])
        - np.maximum(b[:, None, 1], q[None, :, 1]) + 1,
    )
    inter = iw * ih
    return inter / (area_b[:, None] + area_q[None, :] - inter)


def _xywh_to_xyxy_single(bbox):
    x1, y1, w, h = bbox
    return x1, y1, x1 + max(0.0, w - 1.0), y1 + max(0.0, h - 1.0)


@dataclass
class RoidbEntry:
    image_id: int
    file_path: str
    height: int
    width: int
    boxes: np.ndarray          # (N, 4) xyxy — gt first, then proposals
    gt_classes: np.ndarray     # (N,) 0 for proposals
    is_crowd: np.ndarray       # (N,) uint8
    max_overlaps: np.ndarray   # (N,)
    max_classes: np.ndarray    # (N,)
    box_to_gt_ind_map: np.ndarray
    # (N,) annotation ('seg') areas for gt boxes, 0 for proposals — the
    # reference's entry['seg_areas'] (json_dataset.py:187/232), used by
    # the proposal-recall evaluator's area binning
    seg_areas: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    segms: List[object] = field(default_factory=list)
    flipped: bool = False
    bbox_targets: Optional[np.ndarray] = None  # (N, 5) [cls, tx, ty, tw, th]
    # (G, P, 3) [x, y, v] per GT box (keypoint-major; the reference stores
    # the (3, P) transpose per object, json_dataset.py:297-314); None when
    # the dataset has no keypoint annotations
    gt_keypoints: Optional[np.ndarray] = None

    @property
    def num_gt(self) -> int:
        return int((self.gt_classes > 0).sum())


class CocoDataset:
    """COCO json dataset with Detectron roidb semantics."""

    def __init__(self, annotation_file: str, image_directory: str):
        self.coco = COCO(annotation_file)
        self.image_directory = image_directory
        cat_ids = self.coco.get_cat_ids()
        self.classes = ["__background__"] + [
            self.coco.cats[c]["name"] for c in cat_ids
        ]
        self.num_classes = len(self.classes)
        self.json_to_contiguous = {v: i + 1 for i, v in enumerate(cat_ids)}
        self.contiguous_to_json = {v: k for k, v in self.json_to_contiguous.items()}
        self._init_keypoints()

    def _init_keypoints(self):
        """Keypoint metadata for person-keypoint datasets
        (reference json_dataset.py:268-296)."""
        self.keypoints = None
        self.keypoint_flip_map = None
        self.num_keypoints = 0
        for cat in self.coco.cats.values():
            if cat.get("name") == "person" and "keypoints" in cat:
                self.keypoints = list(cat["keypoints"])
                self.num_keypoints = len(self.keypoints)
                self.keypoint_flip_map = {
                    "left_eye": "right_eye", "left_ear": "right_ear",
                    "left_shoulder": "right_shoulder",
                    "left_elbow": "right_elbow", "left_wrist": "right_wrist",
                    "left_hip": "right_hip", "left_knee": "right_knee",
                    "left_ankle": "right_ankle",
                }
                break

    @property
    def keypoint_flip_perm(self) -> Optional[np.ndarray]:
        """(P,) index permutation swapping left/right keypoints under a
        horizontal flip (identity for unpaired ones like 'nose')."""
        if not self.num_keypoints:
            return None
        perm = np.arange(self.num_keypoints)
        idx = {n: i for i, n in enumerate(self.keypoints)}
        for a, b in self.keypoint_flip_map.items():
            if a in idx and b in idx:
                perm[idx[a]] = idx[b]
                perm[idx[b]] = idx[a]
        return perm

    def image_path(self, img: dict) -> str:
        return os.path.join(self.image_directory, img["file_name"])

    # -- roidb -------------------------------------------------------------

    def get_roidb(
        self,
        gt: bool = False,
        proposal_file: Optional[str] = None,
        min_proposal_size: int = 2,
        proposal_limit: int = -1,
        crowd_filter_thresh: float = 0.0,
    ) -> List[RoidbEntry]:
        """reference json_dataset.py:71-114."""
        img_ids = self.coco.get_img_ids()
        entries = []
        for img_id in img_ids:
            img = self.coco.imgs[img_id]
            e = RoidbEntry(
                image_id=img_id,
                file_path=self.image_path(img),
                height=img["height"],
                width=img["width"],
                boxes=np.zeros((0, 4), np.float32),
                gt_classes=np.zeros(0, np.int32),
                is_crowd=np.zeros(0, np.uint8),
                max_overlaps=np.zeros(0, np.float32),
                max_classes=np.zeros(0, np.int32),
                box_to_gt_ind_map=np.zeros(0, np.int32),
            )
            if gt:
                self._add_gt(e)
            entries.append(e)
        gt_overlaps = [self._gt_overlap_matrix(e) for e in entries]
        if proposal_file is not None:
            self._add_proposals_from_file(
                entries, gt_overlaps, proposal_file, min_proposal_size,
                proposal_limit, crowd_filter_thresh,
            )
        for e, ov in zip(entries, gt_overlaps):
            self._assign_classes(e, ov)
        return entries

    def _add_gt(self, e: RoidbEntry):
        """reference json_dataset.py:149-235."""
        boxes, classes, crowd, segms, kps, areas = [], [], [], [], [], []
        for obj in self.coco.load_anns_for_image(e.image_id):
            segm = obj.get("segmentation")
            if isinstance(segm, list):
                segm = [p for p in segm if len(p) >= 6]
            if obj.get("ignore", 0) == 1:
                continue
            x1, y1, x2, y2 = _xywh_to_xyxy_single(obj["bbox"])
            x1 = min(max(x1, 0), e.width - 1)
            y1 = min(max(y1, 0), e.height - 1)
            x2 = min(max(x2, 0), e.width - 1)
            y2 = min(max(y2, 0), e.height - 1)
            if obj["area"] > 0 and x2 > x1 and y2 > y1:
                boxes.append([x1, y1, x2, y2])
                classes.append(self.json_to_contiguous[obj["category_id"]])
                crowd.append(obj.get("iscrowd", 0))
                segms.append(segm)
                areas.append(obj["area"])
                if self.num_keypoints:
                    k = obj.get("keypoints")
                    # the reference stores gt keypoints in an int32 array
                    # (json_dataset.py:297-314 via the np.int32 gt_keypoints
                    # buffer), truncating any fractional coordinate toward
                    # zero; real COCO keypoints are integers so this only
                    # bites synthetic data — match it exactly
                    kps.append(
                        np.asarray(k, np.float64).reshape(-1, 3)
                        .astype(np.int32).astype(np.float32)
                        if k is not None
                        else np.zeros((self.num_keypoints, 3), np.float32)
                    )
        n = len(boxes)
        e.boxes = np.asarray(boxes, np.float32).reshape(n, 4)
        e.gt_classes = np.asarray(classes, np.int32)
        e.is_crowd = np.asarray(crowd, np.uint8)
        e.box_to_gt_ind_map = np.arange(n, dtype=np.int32)
        e.seg_areas = np.asarray(areas, np.float32)
        e.segms = segms
        if self.num_keypoints:
            e.gt_keypoints = np.stack(kps) if kps else np.zeros(
                (0, self.num_keypoints, 3), np.float32
            )

    def _gt_overlap_matrix(self, e: RoidbEntry) -> np.ndarray:
        """(N, num_classes) gt_overlaps: 1.0 at own class for gt boxes,
        -1 rows for crowds (json_dataset.py:224-230)."""
        n = len(e.boxes)
        ov = np.zeros((n, self.num_classes), np.float32)
        for i in range(n):
            if e.is_crowd[i]:
                ov[i, :] = -1.0
            elif e.gt_classes[i] > 0:
                ov[i, e.gt_classes[i]] = 1.0
        return ov

    def _add_proposals_from_file(
        self, entries, gt_overlaps, proposal_file, min_size, top_k, crowd_thresh
    ):
        """reference json_dataset.py:237-266 + _merge/_filter_crowd."""
        with open(proposal_file, "rb") as f:
            proposals = pickle.load(f, encoding="latin1")
        id_field = "indexes" if "indexes" in proposals else "ids"
        order = np.argsort(proposals[id_field])
        prop_boxes = [proposals["boxes"][i] for i in order]
        prop_ids = [proposals[id_field][i] for i in order]
        for i, e in enumerate(entries):
            assert e.image_id == prop_ids[i], "proposal/image id mismatch"
            boxes = np.asarray(prop_boxes[i], np.float32)
            boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, e.width - 1)
            boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, e.height - 1)
            # dedup via coordinate hashing (boxes.py:84-89)
            v = np.array([1, 1e3, 1e6, 1e9])
            hashes = np.round(boxes).dot(v)
            _, keep = np.unique(hashes, return_index=True)
            boxes = boxes[np.sort(keep)]
            ws = boxes[:, 2] - boxes[:, 0] + 1
            hs = boxes[:, 3] - boxes[:, 1] + 1
            boxes = boxes[(ws > min_size) & (hs > min_size)]
            if top_k > 0:
                boxes = boxes[:top_k]
            gt_overlaps[i] = self._merge_proposals(e, gt_overlaps[i], boxes)
        if crowd_thresh > 0:
            for e, i in zip(entries, range(len(entries))):
                gt_overlaps[i] = self._filter_crowd(e, gt_overlaps[i], crowd_thresh)

    def _merge_proposals(self, e: RoidbEntry, gt_ov: np.ndarray, boxes: np.ndarray):
        """reference json_dataset.py:333-392."""
        num = len(boxes)
        new_ov = np.zeros((num, self.num_classes), np.float32)
        b2g = -np.ones(num, np.int32)
        gt_inds = np.where(e.gt_classes > 0)[0]
        if len(gt_inds) > 0 and num > 0:
            overlaps = _np_bbox_overlaps(boxes, e.boxes[gt_inds])
            argmaxes = overlaps.argmax(axis=1)
            maxes = overlaps.max(axis=1)
            pos = np.where(maxes > 0)[0]
            new_ov[pos, e.gt_classes[gt_inds[argmaxes[pos]]]] = maxes[pos]
            b2g[pos] = gt_inds[argmaxes[pos]]
        e.boxes = np.vstack([e.boxes, boxes.astype(np.float32)])
        e.gt_classes = np.concatenate([e.gt_classes, np.zeros(num, np.int32)])
        e.seg_areas = np.concatenate([e.seg_areas, np.zeros(num, np.float32)])
        e.is_crowd = np.concatenate([e.is_crowd, np.zeros(num, np.uint8)])
        e.box_to_gt_ind_map = np.concatenate([e.box_to_gt_ind_map, b2g])
        return np.vstack([gt_ov, new_ov])

    def _filter_crowd(self, e: RoidbEntry, gt_ov: np.ndarray, thresh: float):
        """reference json_dataset.py:397-414 — proposals inside crowd regions
        get overlap -1 (excluded from training)."""
        crowd_inds = np.where(e.is_crowd == 1)[0]
        non_gt = np.where(e.gt_classes == 0)[0]
        if len(crowd_inds) == 0 or len(non_gt) == 0:
            return gt_ov
        # pycocotools-style xywh IoU with crowd denominator
        def xywh(b):
            return np.stack(
                [b[:, 0], b[:, 1], b[:, 2] - b[:, 0] + 1, b[:, 3] - b[:, 1] + 1], 1
            )

        d = xywh(e.boxes[non_gt])
        g = xywh(e.boxes[crowd_inds])
        dx2, dy2 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
        gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
        iw = np.maximum(
            0, np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(d[:, None, 0], g[None, :, 0])
        )
        ih = np.maximum(
            0, np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(d[:, None, 1], g[None, :, 1])
        )
        ious = iw * ih / (d[:, 2] * d[:, 3])[:, None]
        bad = np.where(ious.max(axis=1) > thresh)[0]
        gt_ov[non_gt[bad], :] = -1
        return gt_ov

    @staticmethod
    def _assign_classes(e: RoidbEntry, gt_ov: np.ndarray):
        """reference json_dataset.py:417-435."""
        if len(gt_ov) == 0:
            e.max_overlaps = np.zeros(0, np.float32)
            e.max_classes = np.zeros(0, np.int32)
            return
        e.max_overlaps = gt_ov.max(axis=1)
        e.max_classes = gt_ov.argmax(axis=1).astype(np.int32)
        zero = e.max_overlaps == 0
        assert (e.max_classes[zero] == 0).all()
        nonzero = e.max_overlaps > 0
        assert (e.max_classes[nonzero] != 0).all()


def flip_segms(segms, height: int, width: int):
    """reference lib/utils/segms.py flip_segms: polygons x -> w - x - 1;
    RLE masks flipped columnwise."""
    out = []
    for segm in segms:
        if segm is None:
            out.append(None)
        elif isinstance(segm, list):
            flipped = []
            for poly in segm:
                p = np.asarray(poly, np.float64).copy()
                p[0::2] = width - p[0::2] - 1
                flipped.append(p.tolist())
            out.append(flipped)
        else:
            mask = rle_mod.decode(rle_mod.segmentation_to_rle(segm, height, width))
            out.append(rle_mod.encode(mask[:, ::-1]))
    return out


def flip_keypoints(kps: np.ndarray, flip_perm: np.ndarray,
                   width: int) -> np.ndarray:
    """Horizontal flip of (G, P, 3) gt keypoints: left/right pairs swap via
    `flip_perm` (CocoDataset.keypoint_flip_perm), visible x mirror to
    width - x - 1, unlabeled (v == 0) keypoints zeroed (upstream Detectron
    keypoint_utils.flip_keypoints semantics — a stale nonzero x on an
    unlabeled keypoint must not survive the flip)."""
    out = kps[:, flip_perm].copy()
    vis = out[:, :, 2] > 0
    out[:, :, 0] = np.where(vis, width - out[:, :, 0] - 1, 0.0)
    return out


def extend_with_flipped_entries(
    roidb: List[RoidbEntry],
    keypoint_flip_perm: Optional[np.ndarray] = None,
) -> List[RoidbEntry]:
    """reference roidb.py:103-135. Pass the dataset's keypoint_flip_perm
    for keypoint datasets so flipped entries swap left/right keypoints;
    a keypoint roidb WITHOUT a perm is refused rather than silently
    producing unmirrored keypoints on flipped entries."""
    if keypoint_flip_perm is None and any(
        e.gt_keypoints is not None for e in roidb
    ):
        raise ValueError(
            "roidb carries gt_keypoints: pass keypoint_flip_perm "
            "(CocoDataset.keypoint_flip_perm) so flipped entries mirror "
            "them — flipping boxes but not keypoints corrupts training"
        )
    flipped = []
    for e in roidb:
        boxes = e.boxes.copy()
        boxes[:, 0] = e.width - e.boxes[:, 2] - 1
        boxes[:, 2] = e.width - e.boxes[:, 0] - 1
        assert (boxes[:, 2] >= boxes[:, 0]).all()
        f = RoidbEntry(
            image_id=e.image_id,
            file_path=e.file_path,
            height=e.height,
            width=e.width,
            boxes=boxes,
            gt_classes=e.gt_classes,
            is_crowd=e.is_crowd,
            max_overlaps=e.max_overlaps,
            max_classes=e.max_classes,
            box_to_gt_ind_map=e.box_to_gt_ind_map,
            seg_areas=e.seg_areas,
            segms=flip_segms(e.segms, e.height, e.width),
            flipped=True,
            gt_keypoints=(
                flip_keypoints(e.gt_keypoints, keypoint_flip_perm, e.width)
                if e.gt_keypoints is not None and keypoint_flip_perm is not None
                else e.gt_keypoints
            ),
        )
        flipped.append(f)
    return roidb + flipped


def filter_for_training(
    roidb: List[RoidbEntry],
    fg_thresh: float = 0.5,
    bg_thresh_hi: float = 0.5,
    bg_thresh_lo: float = 0.0,
    require_keypoints: bool = False,
) -> List[RoidbEntry]:
    """reference roidb.py:138-167. require_keypoints additionally drops
    entries with no labeled gt keypoint (upstream Detectron
    roidb.py is_valid when cfg.MODEL.KEYPOINTS_ON)."""

    def valid(e: RoidbEntry) -> bool:
        ov = e.max_overlaps
        fg = np.sum(ov >= fg_thresh)
        bg = np.sum((ov < bg_thresh_hi) & (ov >= bg_thresh_lo))
        ok = fg > 0 or bg > 0
        if ok and require_keypoints:
            ok = (
                e.gt_keypoints is not None
                and (e.gt_keypoints[:, :, 2] > 0).any()
            )
        return ok

    return [e for e in roidb if valid(e)]


def add_bbox_regression_targets(
    roidb: List[RoidbEntry],
    bbox_thresh: float = 0.5,
    bbox_reg_weights=(10.0, 10.0, 5.0, 5.0),
):
    """reference roidb.py:170-206."""
    from detectorch_tpu_torch.ops.boxes import bbox_transform_inv_np

    for e in roidb:
        targets = np.zeros((len(e.boxes), 5), np.float32)
        gt_inds = np.where((e.gt_classes > 0) & (e.is_crowd == 0))[0]
        if len(gt_inds):
            ex_inds = np.where(e.max_overlaps >= bbox_thresh)[0]
            if len(ex_inds):
                ov = _np_bbox_overlaps(e.boxes[ex_inds], e.boxes[gt_inds])
                assignment = ov.argmax(axis=1)
                targets[ex_inds, 0] = e.max_classes[ex_inds]
                targets[ex_inds, 1:] = bbox_transform_inv_np(
                    e.boxes[ex_inds], e.boxes[gt_inds[assignment]],
                    bbox_reg_weights,
                )
        e.bbox_targets = targets


def roidb_for_training(
    annotation_file: str,
    image_directory: str,
    proposal_file: Optional[str] = None,
    crowd_filter_thresh: float = 0.7,
    use_flipped: bool = True,
    fg_thresh: float = 0.5,
    bg_thresh_hi: float = 0.5,
    bg_thresh_lo: float = 0.0,
    bbox_thresh: float = 0.5,
    bbox_reg_weights=(10.0, 10.0, 5.0, 5.0),
    require_keypoints: bool = False,
) -> Tuple[CocoDataset, List[RoidbEntry]]:
    """reference roidb.py:44-100."""
    ds = CocoDataset(annotation_file, image_directory)
    roidb = ds.get_roidb(
        gt=True, proposal_file=proposal_file, crowd_filter_thresh=crowd_filter_thresh
    )
    if use_flipped:
        roidb = extend_with_flipped_entries(roidb, ds.keypoint_flip_perm)
    roidb = filter_for_training(roidb, fg_thresh, bg_thresh_hi, bg_thresh_lo,
                                require_keypoints=require_keypoints)
    add_bbox_regression_targets(roidb, bbox_thresh, bbox_reg_weights)
    return ds, roidb

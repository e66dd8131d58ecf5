"""The comparison that decides ``correct`` for an inference cell.

The reference (``reference/model.py``, fp32, TF32 off) recomputes every
sampled image from its blobs and the same weights, and reads the program's
answers only to judge them, stage by stage, so that a selection flipped by
rounding in one stage does not count against the next:

  * ``roi_unmatched``: the share of the program's proposals that lie under
    IoU ``ROI_IOU`` against every reference proposal (kept with pre- and
    post-NMS counts over the test's by the cell's ``roi_pre_margin`` and by
    ``ROI_MARGIN``, so that the runners-up at either cut still match),
    plus any slots the program left empty where the reference filled them
    at the test's counts, over the reference's filled slots;
  * ``cls_gap``: on the program's rois, each roi's widest gap between the
    program's class probabilities and the reference's;
  * ``det_score_gap``: each of the program's detections is matched to the
    reference's candidates of its class (every roi's box decoded with the
    reference's deltas) that overlap it at IoU ``DET_IOU`` or more; its
    reading is the gap between its score and the nearest of their
    probabilities, 1 where it matches no candidate;
  * ``det_select_gap``: the program's selection against the reference's
    own postprocess on the same rois. Each reference detection that no
    program detection of its class matches at IoU ``DET_IOU`` reads the
    amount by which its score exceeds both the program's cut (its lowest
    score where it filled its cap, else the score threshold) and every
    program detection of its class that would have suppressed it (IoU at
    the NMS threshold, less ``SUPPRESS_IOU_SLACK`` for the boxes' own
    rounding); the program's lowest score reads the amount by which it lies
    under the reference's cut; two program detections of one class that
    overlap at the NMS threshold (plus ``NMS_SLACK``) read 1;
  * ``mask_gap``: on the program's detections and classes, each
    detection's widest gap between the program's mask probabilities and
    the reference's.

Each gap is the widest over every sampled image. Each number has its
limit in the cell's file (``cells/<cell>.json``), with the readings it
was set from in PERF.md.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark.reference import boxes as bx
from benchmark.reference import model as M

ROI_IOU = 0.7          # a program proposal matches a reference one at this IoU
ROI_MARGIN = 200       # reference proposals kept past the post-NMS count
DET_IOU = 0.9          # a detection matches a candidate or a detection at this IoU
NMS_SLACK = 0.001      # two kept detections of a class may overlap up to NMS + this
SUPPRESS_IOU_SLACK = 0.05  # a suppressor overlaps at the NMS threshold less this

NUMBERS = ("roi_unmatched", "cls_gap", "det_score_gap", "det_select_gap", "mask_gap")


class fp32_only:
    """TF32 off for cuBLAS and cuDNN inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _best_iou(a, b):
    """The best IoU of each box of `a` against the boxes `b`."""
    if b.shape[0] == 0:
        return a.new_zeros((a.shape[0],))
    return bx.bbox_overlaps(a, b).max(dim=1).values


def _det_gaps(cand, cand_p, pb, pc, ps):
    """Each program detection's gap to the nearest probability of the
    reference's candidates of its class at IoU >= DET_IOU; 1 for none."""
    gaps = torch.ones_like(ps)
    if not len(cand):
        return gaps
    for c in pc.unique():
        mine = pc == c
        near = bx.bbox_overlaps(pb[mine], cand[:, c]) >= DET_IOU
        g = torch.where(near, (ps[mine][:, None] - cand_p[None, :, c]).abs(),
                        torch.ones_like(near, dtype=torch.float32))
        gaps[mine] = g.min(dim=1).values.clamp_max(1.0)
    return gaps


def _select_gap(ref: M.Detections, pb, pc, ps, t: dict) -> float:
    """The program's selection (boxes, classes, scores) against the
    reference's postprocess: see the module's docstring."""
    k, thresh = t["detections_per_img"], t["score_thresh"]
    rv = ref.valid
    rb, rc, rs = ref.boxes[rv], ref.classes[rv], ref.scores[rv]
    prog_cut = float(ps.min()) if len(ps) >= k else thresh
    ref_cut = float(rs.min()) if len(rs) >= k else thresh
    gap = max(0.0, ref_cut - float(ps.min())) if len(ps) else 0.0
    for c in torch.cat([rc, pc]).unique():
        mine, theirs = pc == c, rc == c
        if int(mine.sum()) > 1:
            pair = bx.bbox_overlaps(pb[mine], pb[mine]).fill_diagonal_(0.0)
            if bool((pair >= t["nms_thresh"] + NMS_SLACK).any()):
                return 1.0
        if not bool(theirs.any()):
            continue
        excuse = torch.full((int(theirs.sum()),), prog_cut, device=rs.device)
        if bool(mine.any()):
            iou = bx.bbox_overlaps(rb[theirs], pb[mine])
            near = iou >= t["nms_thresh"] - SUPPRESS_IOU_SLACK
            by = torch.where(near, ps[mine][None, :], torch.full_like(iou, bx.NEG_INF))
            excuse = torch.maximum(excuse, by.max(dim=1).values)
            excuse[(iou >= DET_IOU).any(dim=1)] = 1.0  # matched
        gap = max(gap, float((rs[theirs] - excuse).clamp_min(0.0).max()))
    return min(1.0, gap)


@torch.no_grad()
def judge_image(cfg: dict, pre_margin: int, P, images, im_scale, orig_h, orig_w, i: int,
                prog: dict, roi_ious: Sequence[float] = ()) -> Dict:
    """The readings of image `i` of a batch against the reference: the
    proposals unmatched at ROI_IOU (and at each of `roi_ious`), and the
    widest gaps."""
    q = M.Precision("float32")
    t = cfg["test"]
    feats = M.features(cfg, P, q, images[i:i + 1])
    s, oh, ow = im_scale[i:i + 1], orig_h[i:i + 1], orig_w[i:i + 1]
    im_h, im_w = M.bounds(cfg, images.shape[1:3], s, oh, ow)
    post = t["rpn_post_nms_top_n"]
    wide = M.proposals(cfg, P, q, feats, im_h, im_w, s, pre=t["rpn_pre_nms_top_n"]
                       + pre_margin, post=post + ROI_MARGIN)
    ref_filled = int(M.proposals(cfg, P, q, feats, im_h, im_w, s).valid.sum())
    rois, ok = prog["rois"].float(), prog["roi_valid"]
    best = _best_iou(rois[ok], wide.boxes[0][wide.valid[0]])
    short = max(0, ref_filled - int(ok.sum()))
    roi_miss = {v: int((best < v).sum()) + short for v in (ROI_IOU, *roi_ious)}

    size = cfg["model"]["box_roi_size"]
    probs, deltas = M.box_head(cfg, P, q, M.roi_feats(cfg, feats, rois, size))
    gap = (prog["cls_scores"].float() - probs).abs().max(dim=1).values
    cls_gap = float(gap[ok].max()) if bool(ok.any()) else 0.0

    ref_det = M.postprocess(cfg, probs, deltas, rois, ok, im_scale[i], orig_h[i], orig_w[i])
    cand = M.decode(cfg, deltas, rois, im_scale[i], orig_h[i], orig_w[i])[ok]
    dv = prog["det_valid"].to(rois.device)
    pb = prog["det_boxes"].to(rois.device).float()[dv]
    pc = prog["det_classes"].to(rois.device)[dv]
    ps = prog["det_scores"].to(rois.device).float()[dv]
    det_gap = float(_det_gaps(cand, probs[ok], pb, pc, ps).max()) if len(ps) else 0.0

    mask_gap = 0.0
    if bool(dv.any()):
        x = M.roi_feats(cfg, feats, pb * im_scale[i], cfg["model"]["mask_roi_size"])
        ref_masks = M.mask_head(cfg, P, q, x, pc)
        mask_gap = float((prog["masks"].to(rois.device).float()[dv] - ref_masks).abs().max())
    return {"roi_miss": roi_miss, "roi_ref": ref_filled, "cls_gap": cls_gap,
            "det_score_gap": det_gap, "det_select_gap": _select_gap(ref_det, pb, pc, ps, t),
            "mask_gap": mask_gap}


def roi_unmatched(rows: List[Dict], iou: float = ROI_IOU) -> float:
    return sum(r["roi_miss"][iou] for r in rows) / max(1, sum(r["roi_ref"] for r in rows))


def combine(rows: List[Dict]) -> Dict[str, float]:
    """Per-image readings -> the cell's numbers."""
    return {"roi_unmatched": roi_unmatched(rows),
            **{k: max(r[k] for r in rows) for k in NUMBERS[1:]}}


def judge_rows(cfg: dict, pre_margin: int, P, samples,
               roi_ious: Sequence[float] = ()) -> List[Dict]:
    """samples: [(Batch, [per-image program answers])] -> per-image readings."""
    rows = []
    with fp32_only():
        for batch, answers in samples:
            for i, prog in enumerate(answers):
                rows.append(judge_image(cfg, pre_margin, P, *batch, i, prog, roi_ious))
    return rows


def judge(cfg: dict, pre_margin: int, P, samples) -> Dict[str, float]:
    """samples: [(Batch, [per-image program answers])] -> the numbers;
    `pre_margin`: the cell's ``roi_pre_margin``."""
    return combine(judge_rows(cfg, pre_margin, P, samples))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit fails."""
    out = {k: {"value": numbers[k], "limit": limits.get(k)} for k in NUMBERS}
    ok = all(v["limit"] is not None and v["value"] <= v["limit"] for v in out.values())
    return ok, out


def control_answers(cfg: dict, P, batch, precision: str = "float8") -> List[dict]:
    """The reference put in the program's place, in a lower precision: its
    answers in the program's form."""
    with fp32_only():
        outs = M.infer(cfg, P, M.Precision(precision), *batch)
    return [{"rois": o.rois, "roi_valid": o.roi_valid, "cls_scores": o.cls_scores,
             "det_boxes": o.det.boxes, "det_scores": o.det.scores, "det_classes": o.det.classes,
             "det_valid": o.det.valid, "masks": o.masks} for o in outs]

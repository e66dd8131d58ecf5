"""Per-image RoI minibatch sampling for Fast R-CNN training (host side).

Reference ``lib/utils/fast_rcnn_sample_rois.py:41-163``. Differences forced
by static shapes: the output is always padded to `rois_per_image` rows with a
validity mask (the reference emits fewer rows when an image lacks rois; its
loss divides by the actual count — we carry the mask into the loss instead).

The port's own copy of ``detectorch_tpu/train/sampler.py``, held to it by
tests/test_torch_host_copies.py, without the keypoint targets, which wait
for the keypoint branch's port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from detectorch_tpu_torch.config import SamplerConfig
from detectorch_tpu_torch.data.coco import RoidbEntry


def expand_bbox_targets(compact: np.ndarray, num_classes: int = 81):
    """(N, 5) [cls, tx, ty, tw, th] -> (N, 4K) targets + inside weights
    (reference fast_rcnn_sample_rois.py:139-163)."""
    n = compact.shape[0]
    targets = np.zeros((n, 4 * num_classes), np.float32)
    inside = np.zeros_like(targets)
    clss = compact[:, 0].astype(np.int32)
    for ind in np.where(clss > 0)[0]:
        s = 4 * clss[ind]
        targets[ind, s : s + 4] = compact[ind, 1:]
        inside[ind, s : s + 4] = 1.0
    return targets, inside


def polys_to_mask_wrt_box(polys, box, resolution: int) -> np.ndarray:
    """Rasterise COCO polygons into an MxM binary mask in the frame of
    `box` (upstream Detectron segm_utils.polys_to_mask_wrt_box — the mask
    TRAINING target transform; the reference repo has no mask training
    code): shift polygons by the box origin, scale to M/box_size, raster,
    binarize. Box width/height are floored at 1 like upstream."""
    from detectorch_tpu_torch.eval.rle import polygons_to_mask

    w = max(float(box[2]) - float(box[0]), 1.0)
    h = max(float(box[3]) - float(box[1]), 1.0)
    norm = []
    for p in polys:
        p = np.asarray(p, np.float64).copy()
        p[0::2] = (p[0::2] - float(box[0])) * resolution / w
        p[1::2] = (p[1::2] - float(box[1])) * resolution / h
        norm.append(p)
    return (polygons_to_mask(norm, resolution, resolution) > 0).astype(np.uint8)


def sample_rois(
    entry: RoidbEntry,
    im_scale: float,
    rng: np.random.RandomState,
    cfg: SamplerConfig = SamplerConfig(),
    num_classes: int = 81,
    compact_targets: bool = False,
    mask_resolution: int = 0,
) -> Dict[str, np.ndarray]:
    """One image -> fixed-shape training blobs.

    Returns rois (R,4 scaled), labels (R,), bbox_targets (R,4K),
    bbox_inside_weights, bbox_outside_weights, valid (R,).

    compact_targets=True skips the host-side 4K expansion and returns
    bbox_targets_compact (R,5) [cls,tx,ty,tw,th] instead — the jitted step
    expands on device (train_step.expand_bbox_targets_device), cutting the
    per-image upload from 3x(R,4K) fp32 (~2 MB) to (R,5) (~10 KB).
    """
    rois_per_image = cfg.rois_per_image
    fg_per_image = int(np.round(cfg.fg_fraction * rois_per_image))
    max_overlaps = entry.max_overlaps

    fg_inds = np.where(max_overlaps >= cfg.fg_thresh)[0]
    fg_count = min(fg_per_image, fg_inds.size)
    if fg_inds.size > 0:
        fg_inds = rng.choice(fg_inds, size=fg_count, replace=False)
    bg_inds = np.where(
        (max_overlaps < cfg.bg_thresh_hi) & (max_overlaps >= cfg.bg_thresh_lo)
    )[0]
    bg_count = min(rois_per_image - fg_count, bg_inds.size)
    if bg_inds.size > 0:
        bg_inds = rng.choice(bg_inds, size=bg_count, replace=False)

    keep = np.append(fg_inds[:fg_count], bg_inds[:bg_count]).astype(np.int64)
    labels = entry.max_classes[keep].copy()
    labels[fg_count:] = 0
    boxes = entry.boxes[keep]

    if entry.bbox_targets is not None:
        compact = entry.bbox_targets[keep]
    else:
        from detectorch_tpu_torch.ops.boxes import bbox_transform_inv_np

        gt_inds = np.where(entry.gt_classes > 0)[0]
        assignments = gt_inds[entry.box_to_gt_ind_map[keep]]
        compact = np.zeros((len(keep), 5), np.float32)
        compact[:, 0] = labels
        compact[:, 1:] = bbox_transform_inv_np(
            boxes, entry.boxes[assignments], (10.0, 10.0, 5.0, 5.0)
        )
    n = len(keep)
    r = rois_per_image
    out = {
        "rois": np.zeros((r, 4), np.float32),
        "labels": np.zeros(r, np.int32),
        "valid": np.zeros(r, bool),
    }
    out["rois"][:n] = boxes * im_scale
    out["labels"][:n] = labels
    out["valid"][:n] = True
    if mask_resolution:
        m = mask_resolution
        out["mask_targets"] = np.zeros((r, m, m), np.uint8)
        out["mask_valid"] = np.zeros(r, bool)
        if fg_count and entry.segms:
            gt_inds = np.where(entry.gt_classes > 0)[0]
            fg_keep = keep[:fg_count]
            for i, ind in enumerate(fg_keep):
                g = entry.box_to_gt_ind_map[ind]
                if g < 0 or g >= len(gt_inds):
                    continue
                segm = entry.segms[gt_inds[g]]
                if not isinstance(segm, list) or not segm:
                    continue  # crowd RLE: never a mask-training target
                out["mask_targets"][i] = polys_to_mask_wrt_box(
                    segm, entry.boxes[ind], m
                )
                out["mask_valid"][i] = True
    if compact_targets:
        out["bbox_targets_compact"] = np.zeros((r, 5), np.float32)
        out["bbox_targets_compact"][:n] = compact
        # background rows carry cls<=0 => zero targets/weights on device
        return out
    targets, inside = expand_bbox_targets(compact, num_classes)
    outside = (inside > 0).astype(np.float32)
    out["bbox_targets"] = np.zeros((r, 4 * num_classes), np.float32)
    out["bbox_inside_weights"] = np.zeros((r, 4 * num_classes), np.float32)
    out["bbox_outside_weights"] = np.zeros((r, 4 * num_classes), np.float32)
    out["bbox_targets"][:n] = targets
    out["bbox_inside_weights"][:n] = inside
    out["bbox_outside_weights"][:n] = outside
    return out

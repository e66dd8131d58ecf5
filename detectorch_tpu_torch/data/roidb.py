"""The training roidb with bbox regression targets, free of JAX.

Port of ``add_bbox_regression_targets`` and ``roidb_for_training`` from
``detectorch_tpu/data/coco.py``. The JAX package's versions encode targets
with ``detectorch_tpu.ops.boxes``, whose package imports every JAX op; these
use the port's numpy copy (``ops.boxes.bbox_transform_inv_np``) and take the
rest (``CocoDataset``, flipping, filtering) from ``data.coco``, which has no
JAX in it. Every entry leaves with ``bbox_targets`` set, so
``train.sampler.sample_rois`` never reaches its own JAX-importing branch.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from detectorch_tpu.data.coco import (
    CocoDataset,
    RoidbEntry,
    _np_bbox_overlaps,
    extend_with_flipped_entries,
    filter_for_training,
)
from detectorch_tpu_torch.ops.boxes import bbox_transform_inv_np


def add_bbox_regression_targets(
    roidb: List[RoidbEntry],
    bbox_thresh: float = 0.5,
    bbox_reg_weights=(10.0, 10.0, 5.0, 5.0),
):
    """Set each entry's ``bbox_targets`` (N, 5) [cls, tx, ty, tw, th]: rois
    with overlap >= bbox_thresh regress to their best non-crowd gt box
    (reference roidb.py:170-206)."""
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
    """Load, flip, filter and add targets (reference roidb.py:44-100)."""
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

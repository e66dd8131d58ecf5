"""RPN head, proposal generation and FPN proposal collection.

Port of ``detectorch_tpu/models/rpn.py``: ``rpn_head``,
``generate_proposals`` (batched over images), ``collect_proposals`` and
``init_rpn_params``. Outputs stay NHWC so that flattening gives the (H, W, A)
anchor order of ``ops.anchors.shifted_anchors``; the delta channel of anchor
a, coordinate k is a*4 + k. ``level_proposals`` is the per-level decode and
NMS that C4's ``generate_proposals`` (one level) and the FPN path's
``models.detector.fpn_proposals`` (P2..P6, then the collect) share.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from detectorch_tpu_torch.models.resnet import conv, to_nchw, to_nhwc
from detectorch_tpu_torch.ops import boxes as box_ops
from detectorch_tpu_torch.ops.anchors import shifted_anchors
from detectorch_tpu_torch.ops.nms import batched_nms, topk_stable


def rpn_head(params, x, prefix: str = "", return_logits: bool = False,
             return_hidden: bool = False):
    """x: (N, H, W, C) NHWC. Returns (cls_prob (N,H,W,A), bbox_pred (N,H,W,4A)),
    both fp32 NHWC. prefix '' for C4 blobs, '_fpn2' for the shared FPN head.
    return_logits=True returns the objectness logits instead of their
    sigmoid (the e2e RPN loss needs logits). return_hidden=True appends the
    hidden activation relu(conv_rpn) (N, H, W, C) in x's dtype, the features
    the objectness probe of ``tools/probe_weights`` is fitted on."""
    xc = to_nchw(x)

    def bias(name):
        return params[name].to(x.dtype)[:, None, None]

    h = F.relu(conv(xc, params[f"conv_rpn{prefix}_w"], pad=1) + bias(f"conv_rpn{prefix}_b"))
    logits = (conv(h, params[f"rpn_cls_logits{prefix}_w"])
              + bias(f"rpn_cls_logits{prefix}_b")).float()
    bbox_pred = (conv(h, params[f"rpn_bbox_pred{prefix}_w"])
                 + bias(f"rpn_bbox_pred{prefix}_b")).float()
    out = (to_nhwc(logits if return_logits else torch.sigmoid(logits)), to_nhwc(bbox_pred))
    return out + (to_nhwc(h),) if return_hidden else out


class Proposals(NamedTuple):
    boxes: torch.Tensor   # (..., post_nms_top_n, 4) fp32, image coords
    scores: torch.Tensor  # (..., post_nms_top_n) fp32
    valid: torch.Tensor   # (..., post_nms_top_n) bool


def anchor_table(fh: int, fw: int, stride: float, sizes: Sequence[float],
                 aspect_ratios: Sequence[float], device, cache: Optional[dict] = None):
    """(fh*fw*A, 4) anchors of one level in the NHWC (H, W, A) order
    (``ops.anchors.shifted_anchors``), kept in `cache` per shape, stride,
    sizes, ratios and device."""
    key = (int(fh), int(fw), float(stride), tuple(sizes), tuple(aspect_ratios), device)
    if cache is not None and key in cache:
        return cache[key]
    table = torch.as_tensor(shifted_anchors(int(fh), int(fw), float(stride), tuple(sizes),
                                            tuple(aspect_ratios)), device=device)
    if cache is not None:
        cache[key] = table
    return table


def level_proposals(level_probs, level_deltas, level_anchors, im_h, im_w, im_scale,
                    pre: int, post: int, nms_thresh: float, min_size: float):
    """Per-level decode of the RPN's outputs and ONE batched NMS over
    (image x level): JAX's ``generate_proposals`` on each level with
    pre_nms_top_n = min(pre, fh*fw*A) and post_nms_top_n = post.

    level_probs (B, fh, fw, A) objectness probabilities, level_deltas
    (B, fh, fw, 4A) and level_anchors (fh*fw*A, 4), per level; im_h, im_w,
    im_scale (B,) clip and min-size bounds. Returns per level Proposals with
    (B, post, ...) fields, in NMS order."""
    h_b, w_b, s_b = im_h[:, None], im_w[:, None], im_scale[:, None]
    # every level padded to the widest level's candidate count
    width = max(min(pre, p[0].numel()) for p in level_probs)

    cand_boxes, cand_scores, cand_valid = [], [], []
    for cls_prob, bbox_pred, anchors in zip(level_probs, level_deltas, level_anchors):
        bsz = cls_prob.shape[0]
        # NHWC flatten == the (H, W, A) anchor order
        scores = cls_prob.reshape(bsz, -1)
        deltas = bbox_pred.reshape(bsz, -1, 4)
        k = min(pre, scores.shape[1])
        top_scores, top_idx = topk_stable(scores, k)
        props = box_ops.bbox_transform(
            anchors[top_idx], torch.gather(deltas, 1, top_idx[..., None].expand(-1, -1, 4)))
        props = box_ops.clip_boxes(props, h_b, w_b)
        ok = box_ops.filter_boxes_mask(props, min_size, s_b, h_b, w_b)
        if k < width:
            props = F.pad(props, (0, 0, 0, width - k))
            top_scores = F.pad(top_scores, (0, width - k))
            ok = F.pad(ok, (0, width - k))
        cand_boxes.append(props)
        cand_scores.append(top_scores)
        cand_valid.append(ok)

    n_lvl = len(level_probs)
    boxes = torch.stack(cand_boxes, dim=1)    # (B, L, width, 4)
    scores = torch.stack(cand_scores, dim=1)  # (B, L, width)
    valid = torch.stack(cand_valid, dim=1)
    bsz = boxes.shape[0]
    idx, ok = batched_nms(
        boxes.reshape(bsz * n_lvl, width, 4), scores.reshape(bsz * n_lvl, width),
        post, nms_thresh, valid=valid.reshape(bsz * n_lvl, width),
    )
    idx = idx.reshape(bsz, n_lvl, post)
    ok = ok.reshape(bsz, n_lvl, post)
    lvl_boxes = torch.gather(boxes, 2, idx[..., None].expand(-1, -1, -1, 4))
    lvl_scores = torch.where(ok, torch.gather(scores, 2, idx),
                             torch.zeros_like(ok, dtype=scores.dtype))
    return [Proposals(boxes=lvl_boxes[:, i], scores=lvl_scores[:, i], valid=ok[:, i])
            for i in range(n_lvl)]


def generate_proposals(cls_prob, bbox_pred, im_height, im_width, scaling_factor,
                       feat_stride: float, anchor_sizes: Sequence[float],
                       anchor_aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                       pre_nms_top_n: int = 6000, post_nms_top_n: int = 1000,
                       nms_thresh: float = 0.7, min_size: float = 0.0,
                       anchor_cache: Optional[dict] = None) -> Proposals:
    """Single-level proposal decode + NMS (C4), batched over images.

    cls_prob (B, H, W, A) fp32 and bbox_pred (B, H, W, 4A); im_height,
    im_width, scaling_factor (B,) clip and min-size bounds. A stable top-k
    to min(pre_nms_top_n, H*W*A), decode, clip, min-size filter and NMS to
    post_nms_top_n; no collect. Returns Proposals with (B, post, ...)
    fields."""
    anchors = anchor_table(cls_prob.shape[1], cls_prob.shape[2], feat_stride, anchor_sizes,
                           anchor_aspect_ratios, cls_prob.device, anchor_cache)
    return level_proposals([cls_prob], [bbox_pred], [anchors], im_height, im_width,
                           scaling_factor, pre_nms_top_n, post_nms_top_n, nms_thresh,
                           min_size)[0]


def collect_proposals(level_props, post_nms_top_n: int = 1000) -> Proposals:
    """FPN 'collect': concatenate per-level padded proposals along the
    proposal axis and keep the global top-N by score (ties to the lower
    concat index); invalid entries sort last. Works on a leading batch."""
    boxes = torch.cat([p.boxes for p in level_props], dim=-2)
    scores = torch.cat([p.scores for p in level_props], dim=-1)
    valid = torch.cat([p.valid for p in level_props], dim=-1)
    neg_inf = torch.full_like(scores, float("-inf"))
    top_scores, top_idx = topk_stable(torch.where(valid, scores, neg_inf), post_nms_top_n)
    ok = top_scores > float("-inf")
    top_boxes = torch.gather(boxes, -2, top_idx[..., None].expand(top_idx.shape + (4,)))
    return Proposals(
        boxes=top_boxes,
        scores=torch.where(ok, torch.gather(scores, -1, top_idx), torch.zeros_like(top_scores)),
        valid=ok,
    )


def init_rpn_params(in_channels: int = 1024, num_anchors: int = 15, prefix: str = "",
                    seed: int = 2):
    """numpy, blob for blob equal to detectorch_tpu.models.rpn (HWIO)."""
    rng = np.random.RandomState(seed)
    p = {}
    p[f"conv_rpn{prefix}_w"] = (rng.randn(3, 3, in_channels, in_channels) * 0.01).astype(np.float32)
    p[f"conv_rpn{prefix}_b"] = np.zeros(in_channels, np.float32)
    p[f"rpn_cls_logits{prefix}_w"] = (rng.randn(1, 1, in_channels, num_anchors) * 0.01).astype(np.float32)
    p[f"rpn_cls_logits{prefix}_b"] = np.zeros(num_anchors, np.float32)
    p[f"rpn_bbox_pred{prefix}_w"] = (rng.randn(1, 1, in_channels, 4 * num_anchors) * 0.01).astype(np.float32)
    p[f"rpn_bbox_pred{prefix}_b"] = np.zeros(4 * num_anchors, np.float32)
    return p

"""RPN head and FPN proposal collection.

Port of ``rpn_head``, ``collect_proposals`` and ``init_rpn_params`` from
``detectorch_tpu/models/rpn.py``. Outputs stay NHWC so that flattening gives
the (H, W, A) anchor order of ``ops.anchors.shifted_anchors``; the delta
channel of anchor a, coordinate k is a*4 + k.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from detectorch_tpu_torch.models.resnet import conv, to_nchw, to_nhwc
from detectorch_tpu_torch.ops.nms import topk_stable


def rpn_head(params, x, prefix: str = "", return_logits: bool = False):
    """x: (N, H, W, C) NHWC. Returns (cls_prob (N,H,W,A), bbox_pred (N,H,W,4A)),
    both fp32 NHWC. prefix '' for C4 blobs, '_fpn2' for the shared FPN head.
    return_logits=True returns the objectness logits instead of their
    sigmoid (the e2e RPN loss needs logits)."""
    xc = to_nchw(x)

    def bias(name):
        return params[name].to(x.dtype)[:, None, None]

    h = F.relu(conv(xc, params[f"conv_rpn{prefix}_w"], pad=1) + bias(f"conv_rpn{prefix}_b"))
    logits = (conv(h, params[f"rpn_cls_logits{prefix}_w"])
              + bias(f"rpn_cls_logits{prefix}_b")).float()
    bbox_pred = (conv(h, params[f"rpn_bbox_pred{prefix}_w"])
                 + bias(f"rpn_bbox_pred{prefix}_b")).float()
    return to_nhwc(logits if return_logits else torch.sigmoid(logits)), to_nhwc(bbox_pred)


class Proposals(NamedTuple):
    boxes: torch.Tensor   # (..., post_nms_top_n, 4) fp32, image coords
    scores: torch.Tensor  # (..., post_nms_top_n) fp32
    valid: torch.Tensor   # (..., post_nms_top_n) bool


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

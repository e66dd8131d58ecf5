"""Keypoint heatmap decoding.

Port of ``detectorch_tpu/ops/keypoints.py`` (upstream Detectron's
``keypoint_utils.heatmaps_to_keypoints`` without its per-roi cubic resize):
the argmax runs on the heatmap's own grid and the half-bin centre rule maps
it into the box,

    x = x1 + (x_int + 0.5) * max(x2 - x1, 1) / heatmap_size,

with the probability of the spatial softmax at the argmax beside the logit.
"""

from __future__ import annotations

import torch


def heatmaps_to_keypoints(heatmaps, boxes):
    """heatmaps (..., H, W, P) fp32 logits; boxes (..., 4) xyxy in
    original-image coords. Returns (..., P, 4) fp32: [x, y, logit, prob]
    per keypoint, keypoint-major.

    The argmax runs over the flattened (H*W) axis of the (..., H*W, P)
    layout, as JAX's, so ties go to the same (first) bin. Every division
    has a tensor divisor, evaluated left to right as JAX writes it: on CUDA
    a division by a Python number is a reciprocal multiply, an ulp off."""
    h, w, p = heatmaps.shape[-3:]
    lead = heatmaps.shape[:-3]
    x1, y1 = boxes[..., 0:1], boxes[..., 1:2]
    widths = torch.clamp_min(boxes[..., 2:3] - boxes[..., 0:1], 1.0)
    heights = torch.clamp_min(boxes[..., 3:4] - boxes[..., 1:2], 1.0)

    flat = heatmaps.reshape(*lead, h * w, p)
    idx = torch.argmax(flat, dim=-2)  # the first maximal index, as jnp.argmax
    logit = flat.amax(dim=-2)
    x_int = (idx % w).float()
    y_int = torch.div(idx, w, rounding_mode="floor").float()
    x = x1 + (x_int + 0.5) * widths / torch.full_like(widths, float(w))
    y = y1 + (y_int + 0.5) * heights / torch.full_like(heights, float(h))
    # the spatial softmax's probability at the argmax: exp(max - max) = 1
    prob = torch.ones_like(logit) / torch.exp(flat - logit[..., None, :]).sum(dim=-2)
    return torch.stack([x, y, logit, prob], dim=-1)

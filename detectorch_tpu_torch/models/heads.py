"""Box, classification and mask heads.

Port of ``detectorch_tpu/models/heads.py`` (the FPN '1up4convs' mask head;
'upshare' waits for the C4 port). Blob names: fc6/fc7, cls_score,
bbox_pred, conv5_mask, mask_fcn_logits, _[mask]_fcn{1..4}.

RoI features are NHWC (R, PH, PW, C) and fc6 flattens them in (H, W, C)
order, as the JAX package does; the RoIAlign kernel writes exactly that
layout, so no transpose sits between it and fc6.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from detectorch_tpu_torch.models.resnet import conv, to_nchw, to_nhwc


def linear(params, x, name: str, dtype=torch.bfloat16):
    """caffe2 FC: weights stored (out, in); y = x @ W^T + b, fp32 out.

    The JAX version multiplies `dtype` operands with fp32 accumulation and
    returns fp32, unrounded. A torch bf16 matmul would round its output to
    bf16, so the operands are rounded to `dtype` and multiplied as fp32:
    the product of two bf16 values is exact in fp32 and the sum accumulates
    in fp32 — the same arithmetic as JAX's preferred_element_type=float32.
    """
    w = params[f"{name}_w"].to(dtype).float()
    b = params[f"{name}_b"].float()
    return torch.addmm(b, x.to(dtype).float(), w.t())


def mlp_box_head(params, roi_feats, dtype=torch.bfloat16):
    """fc6 + fc7: roi_feats (N, 7, 7, 256) -> (N, 1024) fp32."""
    x = roi_feats.reshape(roi_feats.shape[0], -1)
    x = F.relu(linear(params, x, "fc6", dtype))
    return F.relu(linear(params, x, "fc7", dtype))


def box_predictors(params, box_feats, output_prob: bool = True, dtype=torch.bfloat16):
    """cls_score (softmax over classes, or the logits when not output_prob,
    as training uses them) + bbox_pred (4 deltas per class)."""
    cls_score = linear(params, box_feats, "cls_score", dtype)
    if output_prob:
        cls_score = torch.softmax(cls_score, dim=-1)
    return cls_score, linear(params, box_feats, "bbox_pred", dtype)


def deconv2x2(params, x, name: str):
    """ConvTranspose2d(kernel 2, stride 2) on NHWC x: each input pixel emits
    a 2x2 block. Weights (C_in, C_out, 2, 2), ConvTranspose2d's own layout."""
    w = params[f"{name}_w"].to(x.dtype)
    b = params[f"{name}_b"].to(x.dtype)
    y = F.conv_transpose2d(to_nchw(x), w, stride=2) + b[:, None, None]
    return to_nhwc(y)


def four_layer_conv_trunk(params, x):
    """FPN mask trunk on NHWC x: 4x (3x3 conv 256 + relu)."""
    y = to_nchw(x)
    for i in range(1, 5):
        y = F.relu(conv(y, params[f"_[mask]_fcn{i}_w"], pad=1)
                   + params[f"_[mask]_fcn{i}_b"].to(y.dtype)[:, None, None])
    return to_nhwc(y)


def mask_head(params, roi_feats, head_type: str, output_prob: bool = True):
    """Mask branch: roi_feats (N, 14, 14, C) NHWC -> (N, M, M, classes) fp32
    sigmoid probabilities (or the logits when not output_prob)."""
    if head_type == "upshare":
        raise NotImplementedError("the C4 'upshare' mask head is not ported yet")
    if head_type != "1up4convs":
        raise ValueError(head_type)
    x = roi_feats.contiguous()  # NHWC, so the NCHW views below are channels_last
    x = four_layer_conv_trunk(params, x)
    x = F.relu(deconv2x2(params, x, "conv5_mask"))
    logits = conv(to_nchw(x), params["mask_fcn_logits_w"]) \
        + params["mask_fcn_logits_b"].to(x.dtype)[:, None, None]
    logits = to_nhwc(logits.float())
    return torch.sigmoid(logits) if output_prob else logits


# ---------------------------------------------------------------------------
# Random init: numpy, blob for blob equal to detectorch_tpu.models.heads
# ---------------------------------------------------------------------------


def init_box_head_params(box_head: str = "mlp", feat_ch: int = 1024,
                         num_classes: int = 81, seed: int = 3):
    rng = np.random.RandomState(seed)
    p = {}
    if box_head == "mlp":
        p["fc6_w"] = (rng.randn(1024, 7 * 7 * 256) * 0.01).astype(np.float32)
        p["fc6_b"] = np.zeros(1024, np.float32)
        p["fc7_w"] = (rng.randn(1024, 1024) * 0.01).astype(np.float32)
        p["fc7_b"] = np.zeros(1024, np.float32)
    p["cls_score_w"] = (rng.randn(num_classes, feat_ch) * 0.01).astype(np.float32)
    p["cls_score_b"] = np.zeros(num_classes, np.float32)
    p["bbox_pred_w"] = (rng.randn(4 * num_classes, feat_ch) * 0.001).astype(np.float32)
    p["bbox_pred_b"] = np.zeros(4 * num_classes, np.float32)
    return p


def init_mask_head_params(head_type: str = "1up4convs", num_classes: int = 81, seed: int = 4):
    """He/MSRA init on the trunk convs + deconv, Gaussian(0.001) on the
    logits (upstream Detectron's mask_rcnn_heads fills)."""
    rng = np.random.RandomState(seed)
    p = {}
    trunk_out = 256 if head_type == "1up4convs" else 2048
    if head_type == "1up4convs":
        std = np.sqrt(2.0 / (3 * 3 * 256))
        for i in range(1, 5):
            p[f"_[mask]_fcn{i}_w"] = (rng.randn(3, 3, 256, 256) * std).astype(np.float32)
            p[f"_[mask]_fcn{i}_b"] = np.zeros(256, np.float32)
    # stride-2 2x2 deconv: each output pixel sums 1 tap over trunk_out chans
    std = np.sqrt(2.0 / trunk_out)
    p["conv5_mask_w"] = (rng.randn(trunk_out, 256, 2, 2) * std).astype(np.float32)
    p["conv5_mask_b"] = np.zeros(256, np.float32)
    p["mask_fcn_logits_w"] = (rng.randn(1, 1, 256, num_classes) * 0.001).astype(np.float32)
    p["mask_fcn_logits_b"] = np.zeros(num_classes, np.float32)
    return p

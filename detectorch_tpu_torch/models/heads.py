"""Box, classification, mask and keypoint heads.

Port of ``detectorch_tpu/models/heads.py``: the FPN box head (fc6/fc7) and
'1up4convs' mask head, the C4 heads on res5 (``res5_box_head`` and the
'upshare' mask head), and the keypoint head (8 convs, the 4x4/2 deconv and
the fixed bilinear 2x upsample). Blob names: fc6/fc7, cls_score, bbox_pred,
res5_*, conv5_mask, mask_fcn_logits, _[mask]_fcn{1..4}, conv_fcn{1..8},
kps_score_lowres.

RoI features are NHWC (R, PH, PW, C) and fc6 flattens them in (H, W, C)
order, as the JAX package does; the RoIAlign kernel writes exactly that
layout, so no transpose sits between it and fc6.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from detectorch_tpu_torch.models.resnet import c5_head, conv, to_nchw, to_nhwc
from detectorch_tpu_torch.parallel.mesh import column_parallel


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


def mlp_box_head(params, roi_feats, dtype=torch.bfloat16, mesh=None):
    """fc6 + fc7: roi_feats (N, 7, 7, 256) -> (N, 1024) fp32.

    Where `params` hold a model rank's rows of fc6/fc7
    (``parallel.mesh.shard_params`` on a mesh whose 'model' axis is > 1),
    each runs column-parallel over `mesh`: the same bf16-rounded operands
    and fp32 product on the rank's rows, then the columns gathered."""
    x = roi_feats.reshape(roi_feats.shape[0], -1)
    # each layer's full width is the next layer's input width
    x = F.relu(_box_fc(params, x, "fc6", params["fc7_w"].shape[1], dtype, mesh))
    return F.relu(_box_fc(params, x, "fc7", params["cls_score_w"].shape[1], dtype, mesh))


def _box_fc(params, x, name: str, width: int, dtype, mesh):
    rows = params[f"{name}_w"].shape[0]
    if rows == width:
        return linear(params, x, name, dtype)
    if mesh is None or rows * mesh.shape["model"] != width:
        raise ValueError(f"{name}_w holds {rows} of {width} rows, which "
                         f"{'no mesh' if mesh is None else mesh} shards so")
    return column_parallel(x, mesh, lambda xs: linear(params, xs, name, dtype))


def res5_box_head(params, roi_feats, arch: str = "resnet50"):
    """res5 + global average pool: roi_feats (N, 14, 14, 1024) -> (N, 2048)
    fp32 (the mean in the features' dtype, as JAX's)."""
    x = c5_head(params, roi_feats, arch=arch, stride=2)  # (N, 7, 7, 2048)
    return x.mean(dim=(1, 2)).float()


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


def mask_head(params, roi_feats, head_type: str, arch: str = "resnet50",
              output_prob: bool = True):
    """Mask branch: roi_feats (N, 14, 14, C) NHWC -> (N, M, M, classes) fp32
    sigmoid probabilities (or the logits when not output_prob). 'upshare'
    (C4): res5 at stride 2 on 1024 channels; '1up4convs' (FPN): four 3x3
    convs on 256."""
    x = roi_feats.contiguous()  # NHWC, so the NCHW views below are channels_last
    if head_type == "upshare":
        x = c5_head(params, x, arch=arch, stride=2)  # (N, 7, 7, 2048)
    elif head_type == "1up4convs":
        x = four_layer_conv_trunk(params, x)  # (N, 14, 14, 256)
    else:
        raise ValueError(head_type)
    x = F.relu(deconv2x2(params, x, "conv5_mask"))
    logits = conv(to_nchw(x), params["mask_fcn_logits_w"]) \
        + params["mask_fcn_logits_b"].to(x.dtype)[:, None, None]
    logits = to_nhwc(logits.float())
    return torch.sigmoid(logits) if output_prob else logits


def deconv4x4s2(params, x, name: str):
    """ConvTranspose2d(kernel 4, stride 2, padding 1) on NHWC x: an exact 2x
    upsample. JAX convolves the 2x-dilated input, padded by 2, with the
    flipped kernel — the same function. Weights (C_in, C_out, 4, 4),
    ConvTranspose2d's own layout; the output in x's dtype."""
    w = params[f"{name}_w"].to(x.dtype)
    b = params[f"{name}_b"].to(x.dtype)
    y = F.conv_transpose2d(to_nchw(x), w, stride=2, padding=1) + b[:, None, None]
    return to_nhwc(y)


def bilinear_upsample2x(x):
    """Fixed bilinear 2x upsample of NHWC x: a depthwise transposed conv
    k4/s2/p1 whose filter is outer((.25, .75, .75, .25)) (upstream
    Detectron's BilinearInterpolation; symmetric, so flipping it changes
    nothing). Not learned."""
    c = x.shape[-1]
    f = torch.tensor([0.25, 0.75, 0.75, 0.25], dtype=x.dtype, device=x.device)
    w = torch.outer(f, f).expand(c, 1, 4, 4).contiguous()
    return to_nhwc(F.conv_transpose2d(to_nchw(x), w, stride=2, padding=1, groups=c))


def keypoint_head(params, roi_feats, num_convs: int = 8):
    """Keypoint branch: roi_feats (N, 14, 14, C) NHWC -> (N, 56, 56, K) fp32
    heatmap logits: num_convs x (3x3 conv + relu), the 4x4/2 deconv to K
    channels at 28x28 (kps_score_lowres), then the bilinear 2x upsample in
    fp32, as JAX casts before it."""
    y = to_nchw(roi_feats.contiguous())
    for i in range(1, num_convs + 1):
        y = F.relu(conv(y, params[f"conv_fcn{i}_w"], pad=1)
                   + params[f"conv_fcn{i}_b"].to(y.dtype)[:, None, None])
    x = deconv4x4s2(params, to_nhwc(y), "kps_score_lowres")  # (N, 28, 28, K)
    return bilinear_upsample2x(x.float())  # (N, 56, 56, K)


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


def init_keypoint_head_params(num_keypoints: int = 17, num_convs: int = 8,
                              conv_dim: int = 512, in_ch: int = 256,
                              seed: int = 6):
    """He/MSRA init of the trunk convs (HWIO, as JAX's) and the deconv
    (upstream Detectron's MSRAFill): a Gaussian(0.01) trunk would shrink the
    logits to ~1e-4 after 8 layers, where the spatial softmax sits on its
    uniform plateau and the loss cannot move."""
    rng = np.random.RandomState(seed)
    p = {}
    c = in_ch
    for i in range(1, num_convs + 1):
        std = np.sqrt(2.0 / (3 * 3 * c))
        p[f"conv_fcn{i}_w"] = (rng.randn(3, 3, c, conv_dim) * std).astype(np.float32)
        p[f"conv_fcn{i}_b"] = np.zeros(conv_dim, np.float32)
        c = conv_dim
    # stride-2 4x4 deconv: each output pixel sums 2x2 taps over conv_dim channels
    std = np.sqrt(2.0 / (4 * conv_dim))
    p["kps_score_lowres_w"] = (rng.randn(conv_dim, num_keypoints, 4, 4) * std).astype(np.float32)
    p["kps_score_lowres_b"] = np.zeros(num_keypoints, np.float32)
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

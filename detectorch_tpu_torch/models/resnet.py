"""Functional ResNet-50/101 backbone, caffe2-Detectron flavour.

Port of ``detectorch_tpu/models/resnet.py``:

  * the bottleneck's stride 2 sits on the 1x1 ``branch2a`` conv (and the
    ``branch1`` projection), NOT on the 3x3 — torchvision's Bottleneck puts
    it on the 3x3, so it is not reused;
  * BatchNorm is a frozen affine (``*_bn_s`` / ``*_bn_b``);
  * explicit symmetric paddings; the max-pool pads with -inf.

Parameters are a flat ``{caffe2_blob_name: tensor}`` dict with conv weights
in OIHW (``checkpoint/convert.params_from_jax`` turns the JAX package's HWIO
into it). The public functions take and return NHWC tensors, as the JAX
package's do; inside, activations are NCHW views in channels_last memory, so
the NHWC view of any of them is contiguous and costs nothing.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
# stage name -> (caffe2 prefix, out channels of branch2c)
STAGES = (("res2", 256), ("res3", 512), ("res4", 1024), ("res5", 2048))

Params = Dict[str, torch.Tensor]


def to_nchw(x):
    """NHWC -> NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    """NCHW -> NHWC view (contiguous when x is channels_last)."""
    return x.permute(0, 2, 3, 1)


def conv(x, w, stride: int = 1, pad: int = 0):
    """NCHW conv with explicit symmetric padding; w OIHW, cast to x's dtype."""
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=pad)


def affine(x, s, b):
    """Frozen-BN channelwise scale + bias (caffe2 AffineChannel), NCHW."""
    return x * s.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


def conv_bn(params: Params, x, name: str, stride: int = 1, pad: int = 0):
    x = conv(x, params[f"{name}_w"], stride, pad)
    return affine(x, params[f"{name}_bn_s"], params[f"{name}_bn_b"])


def max_pool_3x3s2(x):
    """MaxPool 3x3, stride 2, padding 1; the padding is -inf (NCHW)."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def bottleneck(params: Params, x, prefix: str, stride: int, has_proj: bool):
    """res{s}_{i}: branch2a(1x1, stride)+bn+relu -> branch2b(3x3)+bn+relu ->
    branch2c(1x1)+bn, plus the branch1 projection; relu(sum). NCHW."""
    shortcut = x
    if has_proj:
        shortcut = conv_bn(params, x, f"{prefix}_branch1", stride=stride)
    out = F.relu(conv_bn(params, x, f"{prefix}_branch2a", stride=stride))
    out = F.relu(conv_bn(params, out, f"{prefix}_branch2b", stride=1, pad=1))
    out = conv_bn(params, out, f"{prefix}_branch2c")
    return F.relu(out + shortcut)


def stage(params: Params, x, name: str, n_blocks: int, stride: int):
    for i in range(n_blocks):
        x = bottleneck(params, x, f"{name}_{i}", stride=stride if i == 0 else 1,
                       has_proj=(i == 0))
    return x


def stem(params: Params, x):
    """conv1 7x7/2 pad 3 + frozen BN + relu + maxpool 3x3/2 (NCHW)."""
    x = conv(x, params["conv1_w"], stride=2, pad=3)
    x = F.relu(affine(x, params["res_conv1_bn_s"], params["res_conv1_bn_b"]))
    return max_pool_3x3s2(x)


def c4_body(params: Params, x, arch: str = "resnet50"):
    """conv1..res4 on NHWC x: the C4 conv body, NHWC (N, H/16, W/16, 1024)."""
    blocks = STAGE_BLOCKS[arch]
    x = stem(params, to_nchw(x).contiguous(memory_format=torch.channels_last))
    x = stage(params, x, "res2", blocks[0], stride=1)
    x = stage(params, x, "res3", blocks[1], stride=2)
    return to_nhwc(stage(params, x, "res4", blocks[2], stride=2))


def c5_head(params: Params, x, arch: str = "resnet50", stride: int = 2):
    """res5 on NHWC roi features (the C4 box and mask conv head):
    (R, 14, 14, 1024) -> (R, 7, 7, 2048) NHWC."""
    x = to_nchw(x).contiguous(memory_format=torch.channels_last)
    return to_nhwc(stage(params, x, "res5", STAGE_BLOCKS[arch][3], stride=stride))


def multilevel_body(params: Params, x, arch: str = "resnet50"):
    """conv1..res5 on NHWC x, returning NHWC {c2, c3, c4, c5}."""
    blocks = STAGE_BLOCKS[arch]
    x = stem(params, to_nchw(x).contiguous(memory_format=torch.channels_last))
    c2 = stage(params, x, "res2", blocks[0], stride=1)
    c3 = stage(params, c2, "res3", blocks[1], stride=2)
    c4 = stage(params, c3, "res4", blocks[2], stride=2)
    c5 = stage(params, c4, "res5", blocks[3], stride=2)
    return {"c2": to_nhwc(c2), "c3": to_nhwc(c3), "c4": to_nhwc(c4), "c5": to_nhwc(c5)}


def last_block_name(arch: str, stage_idx: int) -> str:
    """e.g. (resnet50, 2) -> 'res4_5' — used in FPN blob names."""
    name, _ = STAGES[stage_idx]
    return f"{name}_{STAGE_BLOCKS[arch][stage_idx] - 1}"


# ---------------------------------------------------------------------------
# Random init: numpy, blob for blob equal to detectorch_tpu.models.resnet
# (HWIO conv weights, as the JAX package stores them)
# ---------------------------------------------------------------------------


def _he(rng: np.random.RandomState, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    return (rng.randn(kh, kw, cin, cout) * np.sqrt(2.0 / fan_in)).astype(np.float32)


def init_resnet_params(
    arch: str = "resnet50", include_c5: bool = True, seed: int = 0
) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    p: Dict[str, np.ndarray] = {}

    def add_conv_bn(name, kh, kw, cin, cout):
        p[f"{name}_w"] = _he(rng, kh, kw, cin, cout)
        # zero-init the residual-closing BN scale (branch2c) so the random
        # network is near-identity and activations stay bounded
        scale = 0.0 if name.endswith("branch2c") else 1.0
        p[f"{name}_bn_s"] = np.full(cout, scale, np.float32)
        p[f"{name}_bn_b"] = np.zeros(cout, np.float32)

    p["conv1_w"] = _he(rng, 7, 7, 3, 64)
    p["res_conv1_bn_s"] = np.ones(64, np.float32)
    p["res_conv1_bn_b"] = np.zeros(64, np.float32)

    blocks = STAGE_BLOCKS[arch]
    in_ch = 64
    n_stages = 4 if include_c5 else 3
    for si in range(n_stages):
        name, out_ch = STAGES[si]
        mid = out_ch // 4
        for i in range(blocks[si]):
            prefix = f"{name}_{i}"
            if i == 0:
                add_conv_bn(f"{prefix}_branch1", 1, 1, in_ch, out_ch)
            add_conv_bn(f"{prefix}_branch2a", 1, 1, in_ch if i == 0 else out_ch, mid)
            add_conv_bn(f"{prefix}_branch2b", 3, 3, mid, mid)
            add_conv_bn(f"{prefix}_branch2c", 1, 1, mid, out_ch)
        in_ch = out_ch
    return p

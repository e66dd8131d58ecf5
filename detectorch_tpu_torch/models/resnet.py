"""Functional ResNet-50/101 and ResNeXt-101 backbones, caffe2-Detectron flavour.

Port of ``detectorch_tpu/models/resnet.py``:

  * the bottleneck's stride 2 sits on the 1x1 ``branch2a`` conv (and the
    ``branch1`` projection), NOT on the 3x3 — torchvision's Bottleneck puts
    it on the 3x3, so it is not reused;
  * ResNeXt (``resnext101_64x4d``, Xie et al., arXiv:1611.05431, as
    Detectron's ``bottleneck_transformation`` with ``NUM_GROUPS`` 64,
    ``WIDTH_PER_GROUP`` 4 and ``STRIDE_1X1`` False; the port's own, the JAX
    package has none): the 3x3 ``branch2b`` is grouped and carries the
    stride, and the inner width is ``groups * width * 2**s`` at stage s
    (res2 = 0) instead of ``cout // 4``; each grouped conv runs inside a
    ``grouped_conv`` span;
  * BatchNorm is a frozen affine (``*_bn_s`` / ``*_bn_b``). With grad mode
    off (all of inference) it runs fused: the scale folded into the conv's
    weight per call (``ops/cuda/conv_epilogue_kernel.fold_scale``), then bias
    (+ shortcut) (+ relu) as one in-place pass (``conv_epilogue``), a
    projection block's two biases summed into its closing epilogue. With
    grad mode on (a training step), the affine, residual add and relu run as
    separate operators, as autograd needs them;
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

from detectorch_tpu_torch.ops.cuda.conv_epilogue_kernel import conv_epilogue, fold_scale
from detectorch_tpu_torch.utils.profiling import span

STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                "resnext101_64x4d": (3, 4, 23, 3)}
# stage name -> (caffe2 prefix, out channels of branch2c)
STAGES = (("res2", 256), ("res3", 512), ("res4", 1024), ("res5", 2048))
# ResNeXt: arch -> (groups, width per group at res2) of the grouped 3x3
GROUPS = {"resnext101_64x4d": (64, 4)}

Params = Dict[str, torch.Tensor]


def to_nchw(x):
    """NHWC -> NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    """NCHW -> NHWC view (contiguous when x is channels_last)."""
    return x.permute(0, 2, 3, 1)


def conv(x, w, stride: int = 1, pad: int = 0, groups: int = 1):
    """NCHW conv with explicit symmetric padding; w OIHW, cast to x's dtype."""
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=pad, groups=groups)


def affine(x, s, b):
    """Frozen-BN channelwise scale + bias (caffe2 AffineChannel), NCHW."""
    return x * s.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


def fused() -> bool:
    """Whether the frozen-BN convs run fused: with grad mode off, where
    autograd records nothing. With it on (a training step) they run as
    separate operators, the frozen stem and res2 included, so that a step's
    ops, roundings and gradients are those of the unfused form."""
    return not torch.is_grad_enabled()


def folded(params: Params, name: str, dtype):
    """Conv `name`'s weight times its frozen-BN scale, in fp32, rounded once
    to `dtype`: conv(x, W)·s == conv(x, W·s)."""
    return fold_scale(params[f"{name}_w"], params[f"{name}_bn_s"], dtype)


def conv_bn(params: Params, x, name: str, stride: int = 1, pad: int = 0, relu: bool = False):
    """conv + frozen BN (+ relu) of blob `name`: fused with grad mode off,
    else conv, affine (and relu) as they are."""
    w, s, b = params[f"{name}_w"], params[f"{name}_bn_s"], params[f"{name}_bn_b"]
    if not fused():
        x = affine(conv(x, w, stride, pad), s, b)
        return F.relu(x) if relu else x
    return conv_epilogue(conv(x, folded(params, name, x.dtype), stride, pad), b, relu=relu)


def max_pool_3x3s2(x):
    """MaxPool 3x3, stride 2, padding 1; the padding is -inf (NCHW)."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def groups_of(arch: str) -> int:
    """The groups of the arch's 3x3 convs: 1 for ResNet."""
    return GROUPS[arch][0] if arch in GROUPS else 1


def inner_width(arch: str, stage_idx: int) -> int:
    """The bottleneck's inner width at stage `stage_idx` (res2 = 0)."""
    if arch in GROUPS:
        groups, width = GROUPS[arch]
        return groups * width * 2 ** stage_idx
    return STAGES[stage_idx][1] // 4


def bottleneck(params: Params, x, prefix: str, stride: int, has_proj: bool, groups: int = 1):
    """res{s}_{i}: branch2a(1x1)+bn+relu -> branch2b(3x3)+bn+relu ->
    branch2c(1x1)+bn, plus the branch1 projection; relu(sum). NCHW. The
    stride sits on branch2a for ResNet (groups 1), on the grouped branch2b
    for ResNeXt. Fused (``fused()``), the projection runs with its folded
    weight and no epilogue, its bias summed in fp32 into branch2c's, whose
    epilogue adds the shortcut and takes the relu."""
    if not fused():
        return _bottleneck_unfused(params, x, prefix, stride, has_proj, groups)
    dtype = x.dtype
    bias = params[f"{prefix}_branch2c_bn_b"]
    shortcut = x
    if has_proj:
        shortcut = conv(x, folded(params, f"{prefix}_branch1", dtype), stride)
        bias = bias + params[f"{prefix}_branch1_bn_b"]
    if groups == 1:
        out = conv_bn(params, x, f"{prefix}_branch2a", stride=stride, relu=True)
        out = conv_bn(params, out, f"{prefix}_branch2b", pad=1, relu=True)
    else:
        out = conv_bn(params, x, f"{prefix}_branch2a", relu=True)
        w = folded(params, f"{prefix}_branch2b", dtype)
        with span("grouped_conv"):
            out = conv(out, w, stride, 1, groups)
        out = conv_epilogue(out, params[f"{prefix}_branch2b_bn_b"], relu=True)
    out = conv(out, folded(params, f"{prefix}_branch2c", dtype))
    return conv_epilogue(out, bias, shortcut, relu=True)


def _bottleneck_unfused(params: Params, x, prefix: str, stride: int, has_proj: bool,
                        groups: int):
    """The bottleneck as separate operators, for autograd."""
    shortcut = x
    if has_proj:
        shortcut = conv_bn(params, x, f"{prefix}_branch1", stride=stride)
    if groups == 1:
        out = conv_bn(params, x, f"{prefix}_branch2a", stride=stride, relu=True)
        out = conv_bn(params, out, f"{prefix}_branch2b", stride=1, pad=1, relu=True)
    else:
        out = conv_bn(params, x, f"{prefix}_branch2a", relu=True)
        with span("grouped_conv"):
            out = conv(out, params[f"{prefix}_branch2b_w"], stride, 1, groups)
        out = F.relu(affine(out, params[f"{prefix}_branch2b_bn_s"],
                            params[f"{prefix}_branch2b_bn_b"]))
    out = conv_bn(params, out, f"{prefix}_branch2c")
    return F.relu(out + shortcut)


def stage(params: Params, x, arch: str, stage_idx: int, stride: int):
    """Every block of stage `stage_idx` (res2 = 0) of `arch`, NCHW."""
    name, groups = STAGES[stage_idx][0], groups_of(arch)
    for i in range(STAGE_BLOCKS[arch][stage_idx]):
        x = bottleneck(params, x, f"{name}_{i}", stride=stride if i == 0 else 1,
                       has_proj=(i == 0), groups=groups)
    return x


def stem(params: Params, x):
    """conv1 7x7/2 pad 3 + frozen BN + relu + maxpool 3x3/2 (NCHW)."""
    w, s, b = params["conv1_w"], params["res_conv1_bn_s"], params["res_conv1_bn_b"]
    if not fused():
        return max_pool_3x3s2(F.relu(affine(conv(x, w, stride=2, pad=3), s, b)))
    if x.stride(0) == 0:  # a broadcast batch of one: the conv would answer in NCHW
        x = x.clone(memory_format=torch.channels_last)
    x = conv(x, fold_scale(w, s, x.dtype), stride=2, pad=3)
    return max_pool_3x3s2(conv_epilogue(x, b, relu=True))


def c4_body(params: Params, x, arch: str = "resnet50"):
    """conv1..res4 on NHWC x: the C4 conv body, NHWC (N, H/16, W/16, 1024)."""
    x = stem(params, to_nchw(x).contiguous(memory_format=torch.channels_last))
    x = stage(params, x, arch, 0, stride=1)
    x = stage(params, x, arch, 1, stride=2)
    return to_nhwc(stage(params, x, arch, 2, stride=2))


def c5_head(params: Params, x, arch: str = "resnet50", stride: int = 2):
    """res5 on NHWC roi features (the C4 box and mask conv head):
    (R, 14, 14, 1024) -> (R, 7, 7, 2048) NHWC."""
    x = to_nchw(x).contiguous(memory_format=torch.channels_last)
    return to_nhwc(stage(params, x, arch, 3, stride=stride))


def multilevel_body(params: Params, x, arch: str = "resnet50"):
    """conv1..res5 on NHWC x, returning NHWC {c2, c3, c4, c5}."""
    x = stem(params, to_nchw(x).contiguous(memory_format=torch.channels_last))
    c2 = stage(params, x, arch, 0, stride=1)
    c3 = stage(params, c2, arch, 1, stride=2)
    c4 = stage(params, c3, arch, 2, stride=2)
    c5 = stage(params, c4, arch, 3, stride=2)
    return {"c2": to_nhwc(c2), "c3": to_nhwc(c3), "c4": to_nhwc(c4), "c5": to_nhwc(c5)}


def last_block_name(arch: str, stage_idx: int) -> str:
    """e.g. (resnet50, 2) -> 'res4_5' — used in FPN blob names."""
    name, _ = STAGES[stage_idx]
    return f"{name}_{STAGE_BLOCKS[arch][stage_idx] - 1}"


# ---------------------------------------------------------------------------
# Random init: numpy, blob for blob equal to detectorch_tpu.models.resnet
# (HWIO conv weights, as the JAX package stores them); ResNeXt's grouped
# 3x3 is (3, 3, inner // groups, inner)
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
        mid = inner_width(arch, si)
        for i in range(blocks[si]):
            prefix = f"{name}_{i}"
            if i == 0:
                add_conv_bn(f"{prefix}_branch1", 1, 1, in_ch, out_ch)
            add_conv_bn(f"{prefix}_branch2a", 1, 1, in_ch if i == 0 else out_ch, mid)
            add_conv_bn(f"{prefix}_branch2b", 3, 3, mid // groups_of(arch), mid)
            add_conv_bn(f"{prefix}_branch2c", 1, 1, mid, out_ch)
        in_ch = out_ch
    return p

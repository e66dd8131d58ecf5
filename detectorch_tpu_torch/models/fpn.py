"""FPN neck: laterals + nearest top-down + 3x3 output convs (+ P6).

Port of ``detectorch_tpu/models/fpn.py``, same Detectron blob names:

  fpn_inner_res{2,3,4}_{last}_sum_lateral_{w,b}, fpn_inner_res5_{last}_sum_{w,b}
  fpn_res{s}_{last}_sum_{w,b}
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from detectorch_tpu_torch.models.resnet import conv, last_block_name, to_nchw, to_nhwc


def _lateral_name(arch: str, stage_idx: int) -> str:
    blk = last_block_name(arch, stage_idx)
    suffix = "_sum" if stage_idx == 3 else "_sum_lateral"
    return f"fpn_inner_{blk}{suffix}"


def _output_name(arch: str, stage_idx: int) -> str:
    return f"fpn_{last_block_name(arch, stage_idx)}_sum"


def upsample2x_nearest(x):
    """2x nearest upsample of an NHWC tensor (each pixel -> a 2x2 block)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def subsample2x(x):
    """P6 = max_pool2d(P5, kernel 1, stride 2) == strided subsample (NHWC)."""
    return x[:, ::2, ::2, :]


def fpn_neck(params, feats: Dict[str, torch.Tensor], arch: str = "resnet50"):
    """feats: NHWC {c2..c5}. Returns NHWC [P2, P3, P4, P5], finest first."""
    cs = [feats["c2"], feats["c3"], feats["c4"], feats["c5"]]
    lateral = []
    for i, c in enumerate(cs):
        name = _lateral_name(arch, i)
        y = conv(to_nchw(c), params[f"{name}_w"]) + params[f"{name}_b"].to(c.dtype)[:, None, None]
        lateral.append(to_nhwc(y))
    # top-down pass
    for i in range(len(lateral) - 2, -1, -1):
        lateral[i] = lateral[i] + upsample2x_nearest(lateral[i + 1])
    outs = []
    for i, lat in enumerate(lateral):
        name = _output_name(arch, i)
        y = conv(to_nchw(lat), params[f"{name}_w"], pad=1) \
            + params[f"{name}_b"].to(lat.dtype)[:, None, None]
        outs.append(to_nhwc(y))
    return outs


def init_fpn_params(arch: str = "resnet50", channels: int = 256, seed: int = 1):
    """numpy, blob for blob equal to detectorch_tpu.models.fpn (HWIO)."""
    rng = np.random.RandomState(seed)
    p = {}
    in_ch = [256, 512, 1024, 2048]
    for i in range(4):
        ln = _lateral_name(arch, i)
        p[f"{ln}_w"] = (rng.randn(1, 1, in_ch[i], channels) * 0.01).astype(np.float32)
        p[f"{ln}_b"] = np.zeros(channels, np.float32)
        on = _output_name(arch, i)
        p[f"{on}_w"] = (rng.randn(3, 3, channels, channels) * 0.01).astype(np.float32)
        p[f"{on}_b"] = np.zeros(channels, np.float32)
    return p

"""Bridge between the JAX package's flat parameter dict and the port's.

Both packages use the same caffe2 blob names. Layouts differ only for conv
weights:

  * conv weights: JAX stores HWIO, the port OIHW (``F.conv2d``'s layout);
  * deconv weights (``conv5_mask_w``, ``kps_score_lowres_w``) are stored
    (C_in, C_out, kh, kw) by both — ``ConvTranspose2d``'s own layout;
  * fc weights (out, in) pass through: both packages flatten RoI features in
    (H, W, C) order, so fc6's columns need no permutation;
  * BN scale/bias and biases pass through.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

DECONV_WEIGHTS = frozenset({"conv5_mask_w", "kps_score_lowres_w"})


def _is_conv(name: str, a) -> bool:
    return a.ndim == 4 and name not in DECONV_WEIGHTS


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX-layout {blob: array} -> port-layout {blob: CPU tensor}."""
    out = {}
    for name, value in flat.items():
        a = np.asarray(value)
        if _is_conv(name, a):
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def params_to_device(params: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """Move port-layout params to `device`; conv weights go channels_last,
    the layout the convolutions run in."""
    out = {}
    for k, v in params.items():
        v = v.to(device)
        out[k] = v.contiguous(memory_format=torch.channels_last) if v.dim() == 4 else v
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_jax``: port-layout tensors -> JAX-layout numpy."""
    out = {}
    for name, value in params.items():
        a = value.detach().cpu().numpy()
        if _is_conv(name, a):
            a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        out[name] = np.ascontiguousarray(a)
    return out

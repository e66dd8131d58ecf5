"""caffe2 Detectron ``.pkl`` checkpoints -> the port's parameter dict.

Port of ``detectorch_tpu/checkpoint/caffe2_import.py``, whose module imports
the JAX model code. Both packages key parameters by caffe2 blob name; the
port keeps PyTorch's layouts, which are closer to caffe2's than JAX's:

  * conv weights: caffe2 stores OIHW, the port's layout, so they pass as
    they are;
  * ``conv1_w``: BGR -> RGB flip of the input axis (the caffe2 models were
    trained on BGR images);
  * ``fc6_w``: caffe2 flattens the 7x7x256 RoI feature (C, H, W)-major, both
    packages (H, W, C)-major, so the columns are permuted once here;
  * deconv weights (``conv5_mask_w``, ``kps_score_lowres_w``): caffe2's
    (C_in, C_out, kh, kw) is ``ConvTranspose2d``'s layout, kept as it is;
  * BN: caffe2 exports affine-only ``_bn_s``/``_bn_b``; ``fold_bn`` folds
    them into the preceding conv for inference.

The C4 presets' blobs need nothing more: their heads are res5 (the
backbone's own ``res5_*`` blobs), the RPN's ``conv_rpn``/``rpn_*`` carry no
``_fpn2`` suffix, ``conv5_mask_w`` is (2048, 256, 2, 2), and there is no fc6.

Every function returns CPU tensors in the port's layout (those of
``checkpoint.convert.params_from_jax``), float32.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.config import ModelConfig
from detectorch_tpu_torch.models import resnet as resnet_mod


def load_caffe2_pkl(path: str) -> Dict[str, np.ndarray]:
    """Read a Detectron pkl: the raw blob dict, without the {'blobs': ...}
    envelope and without the ``_momentum`` blobs of a training snapshot."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if isinstance(data, dict) and "blobs" in data:
        data = data["blobs"]
    return {k: np.asarray(v) for k, v in data.items() if not k.endswith("_momentum")}


def _from_caffe2(name: str, w: np.ndarray, roi_size: int) -> np.ndarray:
    """One caffe2 blob -> the port's layout, float32."""
    w = np.asarray(w).astype(np.float32)
    if name == "conv1_w":
        w = w[:, (2, 1, 0), :, :]  # BGR -> RGB
    elif name == "fc6_w":
        # (1024, C*H*W) -> columns permuted to (H, W, C)-major
        o = w.shape[0]
        w = w.reshape(o, 256, roi_size, roi_size).transpose(0, 2, 3, 1).reshape(o, -1)
    return np.ascontiguousarray(w)


def _import(blobs, skeleton: Dict[str, torch.Tensor], roi_size: int, strict: bool):
    out: Dict[str, torch.Tensor] = {}
    for name, ref in skeleton.items():
        if name not in blobs:
            if strict:
                raise KeyError(f"checkpoint missing blob: {name}")
            out[name] = ref
            continue
        w = _from_caffe2(name, blobs[name], roi_size)
        if tuple(w.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: checkpoint {w.shape} != model {tuple(ref.shape)}")
        out[name] = torch.from_numpy(w)
    return out


def import_params(blobs: Dict[str, np.ndarray], cfg: ModelConfig,
                  strict: bool = True) -> Dict[str, torch.Tensor]:
    """A caffe2 blob dict -> the port's params for `cfg`: every blob of the
    model's random-init skeleton, filled from `blobs`. A missing blob raises
    KeyError when `strict`, else keeps its random value."""
    from detectorch_tpu_torch.models.detector import init_params

    skeleton = params_from_jax(init_params(cfg))
    return _import(blobs, skeleton, cfg.roi_size, strict)


def import_base_cnn(blobs: Dict[str, np.ndarray], arch: str = "resnet50"):
    """ImageNet base CNN: the backbone's blobs only (conv1 through res5);
    heads keep their random init. Every backbone blob must be present."""
    skeleton = params_from_jax(resnet_mod.init_resnet_params(arch, include_c5=True))
    return _import(blobs, skeleton, roi_size=0, strict=True)  # no fc6 in a backbone


def fold_bn(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold affine BN into the preceding conv: conv(x, W)·s + b ==
    conv(x, W·s) + b, with W in OIHW (s scales the output axis). Exact for
    the frozen affine BN caffe2 Detectron exports; the scales become 1, so
    the model code is unchanged."""
    out = dict(params)
    for name in params:
        if not name.endswith("_bn_s"):
            continue
        base = name[: -len("_bn_s")]
        # the stem pair is (conv1_w, res_conv1_bn_s)
        wkey = "conv1_w" if base == "res_conv1" else f"{base}_w"
        if wkey not in params:
            continue
        s = params[name]
        out[wkey] = (params[wkey] * s[:, None, None, None]).to(params[wkey].dtype)
        out[name] = torch.ones_like(s)
    return out


def export_to_caffe2_layout(params: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Inverse of ``import_params``: numpy blobs in caffe2's layout (RGB ->
    BGR, fc6 columns (C, H, W)-major; OIHW convs as they are)."""
    out = {}
    for name, w in params.items():
        w = w.detach().cpu().numpy()
        if name == "conv1_w":
            w = w[:, (2, 1, 0), :, :]
        elif name == "fc6_w":
            o = w.shape[0]
            w = w.reshape(o, cfg.roi_size, cfg.roi_size, 256).transpose(0, 3, 1, 2).reshape(o, -1)
        out[name] = np.ascontiguousarray(w)
    return out


def save_caffe2_pkl(params: Dict[str, torch.Tensor], cfg: ModelConfig, path: str):
    """Write `params` as a Detectron pkl ({'blobs': ...}, protocol 2)."""
    with open(path, "wb") as f:
        pickle.dump({"blobs": export_to_caffe2_layout(params, cfg)}, f, protocol=2)

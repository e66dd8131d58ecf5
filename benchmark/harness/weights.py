"""Seeded Detectron-format weights, made on the device.

Every blob of the configuration (``reference.model.blob_spec``: caffe2
names and layouts, as a published ``model_final.pkl`` holds them) is drawn
from one normal stream on the device in one call, then scaled blob by blob
by the rules of the configuration's ``weights`` group. The rules set the
magnitudes a trained model works at (``assumed`` in the configuration file
says why each is what it is): activations of order one through the trunk,
RPN logits that do not saturate, class scores of which a few pass the test
threshold on every roi, mask logits away from the binarisation edge.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark.reference.model import blob_spec


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one use (weights, images, sampling) of a run's seed."""
    return int(np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))


def _std(name: str, shape, rules: dict) -> float:
    """The standard deviation of one weight blob."""
    if name in rules["std"]:
        return float(rules["std"][name])
    if name == "conv5_mask_w":  # a stride-2 2x2 deconv: one tap of C_in per output
        return math.sqrt(rules["gain"] / shape[0])
    fan_in = int(np.prod(shape[1:]))
    gain = rules["fpn_gain"] if name.startswith("fpn_") else rules["gain"]
    return math.sqrt(gain / fan_in)


def _bn_scale(name: str, rules: dict) -> float:
    if name == "res_conv1_bn_s":
        return rules["stem_bn_scale"]
    if "_branch2c_" in name:
        return rules["residual_bn_scale"]
    return 1.0


def make_blobs(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{caffe2 blob name: fp32 tensor on `device`} for `cfg` from `seed`."""
    rules = cfg["weights"]
    spec = blob_spec(cfg)
    drawn = [n for n, s in spec.items() if n.endswith("_w")]
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 0))
    total = sum(int(np.prod(spec[n])) for n in drawn)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    blobs, at = {}, 0
    for name in drawn:
        size = int(np.prod(spec[name]))
        blobs[name] = flat[at:at + size].view(spec[name]) * _std(name, spec[name], rules)
        at += size
    del flat
    for name, shape in spec.items():
        if name.endswith("_bn_s"):
            blobs[name] = torch.full(shape, _bn_scale(name, rules), device=device)
        elif name.endswith("_b") or name.endswith("_bn_b"):
            blobs[name] = torch.zeros(shape, device=device)
    return {n: blobs[n] for n in spec}

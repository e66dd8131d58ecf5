"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a seed -> the inputs a cell sends.

``closed_loop_batches``: a pool of ``pool_batches`` batches of ``batch``
blobs, made on the device at set-up and sent in turn by one client, which
sends its next batch when the last one's answer is on the host.
Every seed gets the same multiset of original sizes (``sizes``, each used
equally often) in another order. An image of original size (h, w) is
resized as Detectron's test does (short side ``target_size``, long side at
most ``max_size``) and placed at the top left of the ``bucket`` blob, which
is zero (the pixel mean) elsewhere. Its pixels, mean-subtracted RGB, are a
smooth random field (a normal draw every ``field_stride`` pixels, bilinear
in between, ``field_std``) plus pixel noise (``noise_std``): regions and
edges at many scales, so rois see different content.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.harness.weights import stream_seed

ROOT = Path(__file__).resolve().parents[1]


class Batch(NamedTuple):
    images: torch.Tensor    # (B, H, W, 3) fp32, mean-subtracted RGB, padded
    im_scale: torch.Tensor  # (B,) fp32
    orig_h: torch.Tensor    # (B,) fp32
    orig_w: torch.Tensor    # (B,) fp32


def load(mix: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{mix}.json").read_text())


def compute_scale(h: int, w: int, target: int, max_size: int) -> float:
    """Detectron's test scale (lib/utils/blob.py), np.round in the cap test."""
    scale = float(target) / float(min(h, w))
    if np.round(scale * max(h, w)) > max_size:
        scale = float(max_size) / float(max(h, w))
    return scale


def make_pool(mix: dict, seed: int, device) -> List[Batch]:
    if mix["kind"] != "closed_loop_batches":
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    b, n = mix["batch"], mix["pool_batches"]
    bh, bw = mix["bucket"]
    sizes = [tuple(s) for s in mix["sizes"]]
    rng = np.random.RandomState(stream_seed(seed, 1) % 2 ** 32)
    order = np.resize(np.arange(len(sizes)), b * n)
    rng.shuffle(order)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 2))
    c = mix["content"]
    stride = c["field_stride"]
    pool = []
    for k in range(n):
        images = torch.zeros((b, bh, bw, 3), device=device)
        low = torch.randn((b, 3, bh // stride, bw // stride), generator=gen, device=device)
        field = F.interpolate(low, size=(bh, bw), mode="bilinear", align_corners=False)
        pix = (field * c["field_std"]
               + torch.randn((b, 3, bh, bw), generator=gen, device=device) * c["noise_std"])
        pix = pix.permute(0, 2, 3, 1)
        scales, hs, ws = [], [], []
        for i in range(b):
            h, w = sizes[order[k * b + i]]
            s = compute_scale(h, w, mix["target_size"], mix["max_size"])
            rh, rw = int(round(h * s)), int(round(w * s))
            if rh > bh or rw > bw:
                raise ValueError(f"{h}x{w} resizes to {rh}x{rw}, over the {bh}x{bw} bucket")
            images[i, :rh, :rw] = pix[i, :rh, :rw]
            scales.append(s)
            hs.append(h)
            ws.append(w)
        pool.append(Batch(images, *(torch.tensor(v, dtype=torch.float32, device=device)
                                    for v in (scales, hs, ws))))
    return pool

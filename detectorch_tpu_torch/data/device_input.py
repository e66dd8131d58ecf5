"""On-device image preprocessing: raw uint8 -> padded float32 blobs, batched.

Port of ``detectorch_tpu/data/device_input.py``. The host uploads each
image's raw uint8 pixels (padded to a raw bucket) with ~10 KB of resize
tables; the bilinear resize, the mean subtraction and the zero padding run
on the device, so the fp32 blob never exists on the host and the host does
no resize.

The host half (``_axis_tables``, ``resize_tables``, ``prepare_raw``,
``pack_tables_meta``, ``RAW_STRIDE``) is numpy, copied from the JAX module,
which imports ``jax.numpy``. The tables replicate ``cv2.resize(im, None,
fx=s, fy=s, INTER_LINEAR)`` at the coefficient level: output pixel dx maps to
the source coordinate float32((dx + 0.5) / s - 0.5), floored, with both
borders clamped and their fractions zeroed.

``device_preprocess`` is batched: a stack of raw images of one raw bucket,
each with its own tables and meta, resized into one output bucket. Its blend
order is JAX's — the vertical pass, then the horizontal pass, each
``f[i0]·(1−w) + f[i1]·w`` — and the mean is subtracted after the resize
inside the resized extent only; the padding is exactly 0.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from detectorch_tpu_torch.data.transforms import (
    DEFAULT_BUCKETS,
    PIXEL_MEANS_RGB,
    bucket_shape,
    compute_scale,
    round_up,
)

# raw uint8 images are padded up to multiples of this before upload, so a
# dataset of mixed original sizes falls into a handful of raw buckets
RAW_STRIDE = 160


def _axis_tables(src_len: int, dst_len: int, scale: float, out_cap: int):
    """cv2 INTER_LINEAR index/weight tables for one axis, double precision.

    Returns (i0, w1): (out_cap,) int32 base indices and float32 fractional
    weights; entries >= dst_len are fillers, masked downstream.
    sample(i) = src[i0[i]] * (1 - w1[i]) + src[min(i0[i]+1, src_len-1)] * w1[i]
    """
    dx = np.arange(out_cap, dtype=np.float64)
    # cv2 casts the double coordinate to float before flooring
    fx = ((dx + 0.5) / scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    frac = (fx - sx).astype(np.float32)
    # border clamps with zeroed fraction (resize.cpp xofs construction)
    low = sx < 0
    sx[low] = 0
    frac[low] = 0.0
    high = sx >= src_len - 1
    sx[high] = src_len - 1
    frac[high] = 0.0
    return sx.astype(np.int32), frac


def resize_tables(raw_h: int, raw_w: int, scale: float, out_h: int, out_w: int):
    """Host-side resize tables -> dict of 4 small arrays (~10 KB)."""
    y_i0, y_w1 = _axis_tables(raw_h, int(np.round(raw_h * scale)), scale, out_h)
    x_i0, x_w1 = _axis_tables(raw_w, int(np.round(raw_w * scale)), scale, out_w)
    return {"y_i0": y_i0, "y_w1": y_w1, "x_i0": x_i0, "x_w1": x_w1}


def prepare_raw(
    im_rgb: np.ndarray,
    target_size: int = 800,
    max_size: int = 1333,
    pad_stride: int = 32,
    buckets: Optional[Sequence[Tuple[int, int]]] = DEFAULT_BUCKETS,
    raw_stride: int = RAW_STRIDE,
):
    """Host side: pad the uint8 image to a raw bucket and compute the resize
    tables and scalars the device needs.

    Returns (raw_padded_u8, meta) with meta = dict(tables, raw_h, raw_w,
    rsz_h, rsz_w, scale, out_h, out_w, orig_h, orig_w).
    """
    if im_rgb.ndim == 2:
        im_rgb = np.repeat(im_rgb[:, :, None], 3, axis=2)
    if im_rgb.dtype != np.uint8:
        raise ValueError("device preprocess expects uint8 input")
    h, w = im_rgb.shape[:2]
    scale = compute_scale(h, w, target_size, max_size)
    # cv2 dsize: saturate_cast<int>(src * f) == round-half-to-even
    rsz_h = int(np.round(h * scale))
    rsz_w = int(np.round(w * scale))
    out_h, out_w = bucket_shape(rsz_h, rsz_w, pad_stride, buckets)
    rh, rw = round_up(h, raw_stride), round_up(w, raw_stride)
    raw = np.zeros((rh, rw, 3), np.uint8)
    raw[:h, :w] = im_rgb
    meta = {
        "tables": resize_tables(h, w, scale, out_h, out_w),
        "raw_h": h, "raw_w": w, "rsz_h": rsz_h, "rsz_w": rsz_w,
        "scale": scale, "out_h": out_h, "out_w": out_w,
        "orig_h": h, "orig_w": w,
    }
    return raw, meta


def pack_tables_meta(m) -> Tuple[np.ndarray, np.ndarray]:
    """Pack `prepare_raw`'s tables and scalars into one (4, L) f32 array
    (rows y_i0, y_w1, x_i0, x_w1; L = max(out_h, out_w)) and one 7-vector
    (raw_h, raw_w, rsz_h, rsz_w, scale, orig_h, orig_w): the layout
    ``device_preprocess`` and the engine read. Indices stored as f32 are
    exact below 2^24."""
    t = m["tables"]
    L = max(m["out_h"], m["out_w"])
    tables = np.zeros((4, L), np.float32)
    tables[0, : m["out_h"]] = t["y_i0"]
    tables[1, : m["out_h"]] = t["y_w1"]
    tables[2, : m["out_w"]] = t["x_i0"]
    tables[3, : m["out_w"]] = t["x_w1"]
    meta = np.asarray(
        [m["raw_h"], m["raw_w"], m["rsz_h"], m["rsz_w"],
         m["scale"], m["orig_h"], m["orig_w"]], np.float32)
    return tables, meta


def device_preprocess(raw_u8, tables, meta, out_h: int, out_w: int,
                      pixel_means=PIXEL_MEANS_RGB):
    """(B, RH, RW, 3) uint8 raw images -> (B, out_h, out_w, 3) fp32 blobs.

    tables (B, 4, L) and meta (B, 7) are ``pack_tables_meta``'s, stacked;
    out_h/out_w is the output bucket (every image of the batch shares it).
    Each image is gathered with its own tables; indices become int64 on the
    device.
    """
    bsz, _, raw_w_pad, ch = raw_u8.shape
    f = raw_u8.float()
    y_i0 = tables[:, 0, :out_h].long()
    y_w1 = tables[:, 1, :out_h]
    x_i0 = tables[:, 2, :out_w].long()
    x_w1 = tables[:, 3, :out_w]
    raw_h = meta[:, 0].long()[:, None]
    raw_w = meta[:, 1].long()[:, None]
    i1y = torch.minimum(y_i0 + 1, raw_h - 1)
    i1x = torch.minimum(x_i0 + 1, raw_w - 1)

    def rows(idx):  # (B, out_h) -> (B, out_h, RW, 3)
        return torch.gather(f, 1, idx[:, :, None, None].expand(bsz, out_h, raw_w_pad, ch))

    def cols(v, idx):  # (B, out_w) -> (B, out_h, out_w, 3)
        return torch.gather(v, 2, idx[:, None, :, None].expand(bsz, out_h, out_w, ch))

    # vertical pass, then horizontal
    v = rows(y_i0) * (1.0 - y_w1)[:, :, None, None] + rows(i1y) * y_w1[:, :, None, None]
    im = cols(v, x_i0) * (1.0 - x_w1)[:, None, :, None] + cols(v, i1x) * x_w1[:, None, :, None]
    dev = raw_u8.device
    valid = (torch.arange(out_h, device=dev)[None, :, None] < meta[:, 2, None, None].long()) \
        & (torch.arange(out_w, device=dev)[None, None, :] < meta[:, 3, None, None].long())
    means = torch.as_tensor(np.asarray(pixel_means, np.float32), device=dev)
    return torch.where(valid[..., None], im - means, torch.zeros((), device=dev))

"""Anchor enumeration — host-side static precompute.

A copy of ``detectorch_tpu/ops/anchors.py`` (numpy only): importing it from
the JAX package would run ``detectorch_tpu/ops/__init__.py``, which imports
JAX.

Reproduces the classic py-faster-rcnn anchor table (reference
``lib/utils/generate_anchors.py:54-123``) including the integer rounding of
widths in ratio enumeration (``:111-112``), which must match the matlab table
in the reference's header comment bit-for-bit.

Anchors depend only on (stride, sizes, ratios, feature H, W) — all static
under jit — so they are computed once in numpy and closed over as constants in
the compiled program (no host round-trip at runtime, unlike reference
``generate_proposals.py:124-149`` which rebuilds them per forward call).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


def _whctrs(anchor: np.ndarray):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    x_ctr = anchor[0] + 0.5 * (w - 1)
    y_ctr = anchor[1] + 0.5 * (h - 1)
    return w, h, x_ctr, y_ctr


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack(
        (
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        )
    )


def _ratio_enum(anchor, ratios):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    size = w * h
    size_ratios = size / ratios
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * ratios)
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def _scale_enum(anchor, scales):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    ws = w * scales
    hs = h * scales
    return _mkanchors(ws, hs, x_ctr, y_ctr)


@functools.lru_cache(maxsize=None)
def generate_anchors(
    stride: float = 16.0,
    sizes: Tuple[float, ...] = (32, 64, 128, 256, 512),
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """(A, 4) float32 cell anchors centered on the (0,0) stride cell.

    Ordering is ratio-major then scale (matches reference :68-77), so the A
    axis lines up with the RPN conv output channel ordering.
    """
    scales = np.array(sizes, dtype=np.float64) / stride
    ratios = np.array(aspect_ratios, dtype=np.float64)
    base = np.array([1, 1, stride, stride], dtype=np.float64) - 1
    ratio_anchors = _ratio_enum(base, ratios)
    anchors = np.vstack(
        [_scale_enum(ratio_anchors[i, :], scales) for i in range(ratio_anchors.shape[0])]
    )
    return anchors.astype(np.float32)


@functools.lru_cache(maxsize=None)
def shifted_anchors(
    feature_height: int,
    feature_width: int,
    stride: float,
    sizes: Tuple[float, ...],
    aspect_ratios: Tuple[float, ...],
) -> np.ndarray:
    """All anchors on the H×W grid, shape (H*W*A, 4), ordered (H, W, A)
    slowest-to-fastest — exactly the layout an NHWC conv output flattens to
    (reference generate_proposals.py:124-149, :58-73).
    """
    anchors = generate_anchors(stride, tuple(sizes), tuple(aspect_ratios))
    shift_x = np.arange(0, feature_width, dtype=np.float32) * stride
    shift_y = np.arange(0, feature_height, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    all_anchors = anchors[None, :, :] + shifts[:, None, :]
    return all_anchors.reshape(-1, 4).astype(np.float32)


def fpn_anchor_sizes(level: int) -> Tuple[float, ...]:
    """Per-FPN-level single anchor size: 32·2^(level-2) for P2..P6
    (reference detector.py:205: anchor_sizes=(32*2**i,))."""
    return (32.0 * 2 ** (level - 2),)

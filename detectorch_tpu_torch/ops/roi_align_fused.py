"""Differentiable multilevel RoIAlign for training: forward and backward kernels.

Counterpart of ``make_multilevel_roi_align_fused``
(``detectorch_tpu/ops/roi_align.py:515-620``). The JAX package pairs the
Pallas slab forward with a choice of VJPs; the port computes RoIAlign and
its feature gradient exactly for every roi, so its one function is what
JAX's exact choices compute: the forward is ``roi_align_fwd`` and the
backward ``roi_align_bwd`` (the CUDA kernels on CUDA tensors, the plain
PyTorch versions on CPU tensors); ``roi_align_c4_fused`` is the same for the
C4 call site (JAX's ``roi_align_matmul`` under ``jax.grad``). Rois, image
indices and levels receive no
gradient, as in JAX (``roi_align.py:612-617``) and in the reference's CUDA
backward, which differentiates the features only.
"""

from __future__ import annotations

from typing import Sequence

import torch

from detectorch_tpu_torch.ops.cuda.roi_align_kernel import (
    roi_align_bwd,
    roi_align_c4,
    roi_align_c4_bwd,
    roi_align_fwd,
)

# JAX's train_step.ROI_ALIGN_IMPLS
ROI_ALIGN_IMPLS = ("gather", "pallas", "pallas-mm", "pallas-slab", "pallas-zero")


def check_roi_align_impl(roi_align_impl: str, bwd_precision: str = "highest") -> None:
    """Accept the JAX names whose gradient is exact; refuse the others.

    'gather', 'pallas' and 'pallas-slab' differentiate RoIAlign exactly, and
    so does 'pallas-mm' at bwd_precision 'highest': all of them run the
    port's one exact function. 'pallas-mm' at a lower tier (bf16-rounded
    weights) and 'pallas-zero' (a zero gradient, for profiling) are refused
    rather than run at another precision."""
    if roi_align_impl not in ROI_ALIGN_IMPLS:
        raise ValueError(f"unknown roi_align_impl {roi_align_impl!r}; "
                         f"expected one of {ROI_ALIGN_IMPLS}")
    if roi_align_impl == "pallas-zero" or (
            roi_align_impl == "pallas-mm" and bwd_precision != "highest"):
        raise ValueError(
            f"roi_align_impl {roi_align_impl!r} with bwd_precision {bwd_precision!r} "
            "is not supported by the port: its RoIAlign gradient is exact "
            "('gather', 'pallas', 'pallas-slab', or 'pallas-mm' at 'highest')")


class _RoIAlign(torch.autograd.Function):
    """The levels come as ``*features``: an autograd.Function differentiates
    the tensors among its arguments, not tensors inside a list."""

    @staticmethod
    def forward(ctx, rois, batch_idx, levels, spec, fwd, bwd, *features):
        level_scales, pooled_h, pooled_w, sampling_ratio, max_grid = spec
        ctx.save_for_backward(rois, batch_idx, levels)
        ctx.spec = spec
        ctx.bwd = bwd
        ctx.shapes = [tuple(f.shape) for f in features]
        ctx.dtype = features[0].dtype
        return fwd(list(features), rois, batch_idx, levels, level_scales,
                   pooled_h, pooled_w, sampling_ratio, max_grid)

    @staticmethod
    def backward(ctx, g):
        rois, batch_idx, levels = ctx.saved_tensors
        level_scales, pooled_h, pooled_w, sampling_ratio, max_grid = ctx.spec
        grads = ctx.bwd(g.contiguous(), ctx.shapes, rois, batch_idx, levels,
                        level_scales, pooled_h, pooled_w, sampling_ratio, max_grid,
                        out_dtype=ctx.dtype)
        return (None, None, None, None, None, None, *grads)


def roi_align_fused(
    feature_list: Sequence[torch.Tensor],
    rois: torch.Tensor,
    batch_idx: torch.Tensor,
    levels: torch.Tensor,
    level_scales: Sequence[float],
    pooled_h: int,
    pooled_w: int,
    sampling_ratio: int = 2,
    max_grid: int = 8,
    fwd=roi_align_fwd,
    bwd=roi_align_bwd,
) -> torch.Tensor:
    """RoIAlign with a gradient for the features: (R, PH, PW, C) fp32.

    Takes the arguments of ``roi_align_fwd``; the gradient of each level
    comes back in that level's dtype, summed in fp32 and rounded once.
    `fwd` and `bwd` are the kernels' wrappers; a comparison on the card
    passes the plain versions (``ops.roi_align.multilevel_roi_align`` and
    ``multilevel_roi_align_backward``) by name."""
    spec = (tuple(level_scales), pooled_h, pooled_w, sampling_ratio, max_grid)
    return _RoIAlign.apply(rois, batch_idx, levels, spec, fwd, bwd, *feature_list)


class _RoIAlignC4(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, rois, spec, fwd, bwd):
        ctx.save_for_backward(rois)
        ctx.spec, ctx.bwd = spec, bwd
        ctx.shape, ctx.dtype = tuple(features.shape), features.dtype
        return fwd(features, rois, *spec)

    @staticmethod
    def backward(ctx, g):
        rois, = ctx.saved_tensors
        grad = ctx.bwd(g.contiguous(), ctx.shape, rois, *ctx.spec, out_dtype=ctx.dtype)
        return grad, None, None, None, None


def roi_align_c4_fused(features, rois, pooled_h: int, pooled_w: int, spatial_scale: float,
                       sampling_ratio: int = 0, max_grid: int = 8, fwd=roi_align_c4,
                       bwd=roi_align_c4_bwd) -> torch.Tensor:
    """C4 RoIAlign with a gradient for the features: takes the arguments of
    ``roi_align_c4`` and returns (B, N, PH, PW, C) fp32; the gradient comes
    back in the features' dtype, summed in fp32 and rounded once. A
    comparison on the card passes the plain versions
    (``ops.roi_align.roi_align_matmul`` and ``roi_align_matmul_backward``)."""
    spec = (pooled_h, pooled_w, spatial_scale, sampling_ratio, max_grid)
    return _RoIAlignC4.apply(features, rois, spec, fwd, bwd)

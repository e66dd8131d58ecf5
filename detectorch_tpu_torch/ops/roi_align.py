"""RoIAlign in plain PyTorch — exact caffe2 semantics, the kernel's reference.

Port of ``_roi_geometry``, ``_sample_coords`` and ``multilevel_roi_align``
from ``detectorch_tpu/ops/roi_align.py``, with an explicit per-roi image
index so one call serves a whole batch:

  * roi coords scaled by the level's spatial scale with NO rounding;
  * malformed rois forced to at least 1x1 in feature coords;
  * per-bin sample grid = ``sampling_ratio`` if > 0, else
    ``ceil(roi_size / pooled_size)`` clipped to [1, max_grid] (adaptive);
  * samples with y < -1 or y > height (x ditto) contribute zero but still
    count in the bin average (count = grid_h * grid_w);
  * coordinates clamp into [0, size-1]; y_high = min(y_low + 1, size - 1).

This is the plain version that sits beside the CUDA kernel
(``ops/cuda/roi_align_kernel.py``): CPU tensors run it, and the kernel is
held to it on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch


def roi_geometry(rois, spatial_scale, pooled_h: int, pooled_w: int,
                 sampling_ratio: int, max_grid: int):
    """Per-roi geometry. rois (N, 4) image-space xyxy; spatial_scale a
    number or (N,). Returns start_h/w, bin_h/w (fp32) and grid_h/w (int32),
    all (N,)."""
    s = torch.as_tensor(spatial_scale, dtype=torch.float32, device=rois.device)
    start_w = rois[:, 0] * s
    start_h = rois[:, 1] * s
    end_w = rois[:, 2] * s
    end_h = rois[:, 3] * s
    roi_w = torch.clamp_min(end_w - start_w, 1.0)
    roi_h = torch.clamp_min(end_h - start_h, 1.0)
    # divide by tensors: on CUDA, PyTorch turns division by a Python number
    # into multiplication by its reciprocal, an ulp off the true quotient
    # that caffe2, JAX and the kernel compute
    bin_h = roi_h / torch.full_like(roi_h, pooled_h)
    bin_w = roi_w / torch.full_like(roi_w, pooled_w)
    if sampling_ratio > 0:
        grid_h = torch.full_like(start_h, sampling_ratio, dtype=torch.int32)
        grid_w = grid_h
    else:
        grid_h = torch.clamp(torch.ceil(bin_h), 1, max_grid).to(torch.int32)
        grid_w = torch.clamp(torch.ceil(bin_w), 1, max_grid).to(torch.int32)
    return start_h, start_w, bin_h, bin_w, grid_h, grid_w


def sample_coords(start, bin_size, grid, pooled: int, max_grid: int):
    """Sample positions along one axis, (N, pooled, max_grid) fp32:
    coord = start + p*bin + (i+0.5)*bin/grid; entries with i >= grid are
    masked out by the caller."""
    dev = start.device
    p = torch.arange(pooled, dtype=torch.float32, device=dev)[None, :, None]
    i = torch.arange(max_grid, dtype=torch.float32, device=dev)[None, None, :]
    g = grid.to(torch.float32)[:, None, None]
    b = bin_size[:, None, None]
    return start[:, None, None] + p * b + ((i + 0.5) * b / g)


def multilevel_roi_align(
    feature_list: Sequence[torch.Tensor],
    rois,
    batch_idx,
    levels,
    level_scales: Sequence[float],
    pooled_h: int,
    pooled_w: int,
    sampling_ratio: int = 2,
    max_grid: int = 8,
):
    """RoIAlign over FPN levels by an exact gather of the four bilinear taps.

    feature_list: per level (B, H_l, W_l, C), finest first (any strides);
    rois: (R, 4) image-space xyxy fp32; batch_idx: (R,) image of each roi;
    levels: (R,) index into feature_list. Returns (R, PH, PW, C) fp32.
    """
    dev = rois.device
    channels = feature_list[0].shape[-1]
    shapes = torch.tensor([list(f.shape[1:3]) for f in feature_list],
                          dtype=torch.int64, device=dev)  # (L, 2)
    sizes = [f.numel() // channels for f in feature_list]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                           dtype=torch.int64, device=dev)
    flat = torch.cat([f.reshape(-1, channels) for f in feature_list]).float()

    levels = levels.long()
    scales = torch.tensor(list(level_scales), dtype=torch.float32, device=dev)
    lvl_h = shapes[levels, 0]
    lvl_w = shapes[levels, 1]
    base = offsets[levels] + batch_idx.long() * lvl_h * lvl_w

    start_h, start_w, bin_h, bin_w, grid_h, grid_w = roi_geometry(
        rois.float(), scales[levels], pooled_h, pooled_w, sampling_ratio, max_grid
    )
    if sampling_ratio > 0:
        max_grid = sampling_ratio
    ys = sample_coords(start_h, bin_h, grid_h, pooled_h, max_grid)  # (R, PH, S)
    xs = sample_coords(start_w, bin_w, grid_w, pooled_w, max_grid)  # (R, PW, S)

    fh = lvl_h.float()[:, None, None]
    fw = lvl_w.float()[:, None, None]
    sidx = torch.arange(max_grid, device=dev)[None, None, :]
    live_y = (ys >= -1.0) & (ys <= fh) & (sidx < grid_h[:, None, None])
    live_x = (xs >= -1.0) & (xs <= fw) & (sidx < grid_w[:, None, None])
    ysc = torch.minimum(torch.clamp_min(ys, 0.0), fh - 1.0)
    xsc = torch.minimum(torch.clamp_min(xs, 0.0), fw - 1.0)

    r = rois.shape[0]
    full = (r, pooled_h, pooled_w, max_grid, max_grid)
    yy = ysc[:, :, None, :, None].expand(full).reshape(r, -1)
    xx = xsc[:, None, :, None, :].expand(full).reshape(r, -1)
    live = (live_y[:, :, None, :, None] & live_x[:, None, :, None, :]).reshape(r, -1).float()

    y_max = (lvl_h - 1)[:, None]
    x_max = (lvl_w - 1)[:, None]
    y0 = torch.minimum(torch.floor(yy).long().clamp_min(0), y_max)
    x0 = torch.minimum(torch.floor(xx).long().clamp_min(0), x_max)
    y1 = torch.minimum(y0 + 1, y_max)
    x1 = torch.minimum(x0 + 1, x_max)
    ly = yy - y0.float()
    lx = xx - x0.float()
    hy = 1.0 - ly
    hx = 1.0 - lx
    row = lvl_w[:, None]

    def take(yi, xi):
        idx = base[:, None] + yi * row + xi
        return flat[idx.reshape(-1)].reshape(idx.shape + (channels,))

    vals = (
        take(y0, x0) * (hy * hx * live)[..., None]
        + take(y0, x1) * (hy * lx * live)[..., None]
        + take(y1, x0) * (ly * hx * live)[..., None]
        + take(y1, x1) * (ly * lx * live)[..., None]
    )
    summed = vals.reshape(r, pooled_h, pooled_w, max_grid * max_grid, channels).sum(dim=3)
    inv_count = 1.0 / (grid_h * grid_w).float()
    return summed * inv_count[:, None, None, None]

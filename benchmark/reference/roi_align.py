"""RoIAlign in plain PyTorch, caffe2 semantics, and the work it needs.

Frozen copies of the port's plain versions:

  * roi coordinates scaled with no rounding, malformed rois forced to 1x1;
  * per-bin grid ``sampling_ratio`` if > 0, else ceil(roi / pooled) clipped
    to [1, max_grid];
  * samples outside [-1, size] add zero but count in the bin's mean;
  * ``multilevel_roi_align`` gathers the four bilinear taps of every sample
    (the FPN form, sampling ratio 2), ``roi_align_matmul`` contracts per-axis
    hat weights (the C4 form, adaptive grid; the gather form would pad
    every bin to 64 samples).

``gather_work`` and ``separable_work`` count what a call over given rois
needs: the feature pixels its taps touch, each once, and its fp32
operations. They give the kernel's roofline bound, whatever implements it.
"""

from __future__ import annotations

from typing import Sequence

import torch


def roi_geometry(rois, spatial_scale, pooled_h: int, pooled_w: int, sampling_ratio: int,
                 max_grid: int):
    s = torch.as_tensor(spatial_scale, dtype=torch.float32, device=rois.device)
    start_w, start_h = rois[:, 0] * s, rois[:, 1] * s
    roi_w = torch.clamp_min(rois[:, 2] * s - start_w, 1.0)
    roi_h = torch.clamp_min(rois[:, 3] * s - start_h, 1.0)
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
    dev = start.device
    p = torch.arange(pooled, dtype=torch.float32, device=dev)[None, :, None]
    i = torch.arange(max_grid, dtype=torch.float32, device=dev)[None, None, :]
    g = grid.to(torch.float32)[:, None, None]
    b = bin_size[:, None, None]
    return start[:, None, None] + p * b + ((i + 0.5) * b / g)


def bilinear_taps(level_shapes, rois, batch_idx, levels, level_scales, pooled: int,
                  sampling_ratio: int, max_grid: int = 8):
    """Flat table rows and weights of the four taps of every sample, over
    the levels stacked into one (sum_l B*H_l*W_l, C) table.
    level_shapes: per level (B, H_l, W_l)."""
    dev = rois.device
    shapes = torch.tensor([list(s[1:3]) for s in level_shapes], dtype=torch.int64, device=dev)
    sizes = [int(s[0]) * int(s[1]) * int(s[2]) for s in level_shapes]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], dtype=torch.int64,
                           device=dev)
    levels = levels.long()
    scales = torch.tensor(list(level_scales), dtype=torch.float32, device=dev)
    lvl_h, lvl_w = shapes[levels, 0], shapes[levels, 1]
    base = offsets[levels] + batch_idx.long() * lvl_h * lvl_w
    start_h, start_w, bin_h, bin_w, grid_h, grid_w = roi_geometry(
        rois.float(), scales[levels], pooled, pooled, sampling_ratio, max_grid)
    if sampling_ratio > 0:
        max_grid = sampling_ratio
    ys = sample_coords(start_h, bin_h, grid_h, pooled, max_grid)
    xs = sample_coords(start_w, bin_w, grid_w, pooled, max_grid)
    fh = lvl_h.float()[:, None, None]
    fw = lvl_w.float()[:, None, None]
    sidx = torch.arange(max_grid, device=dev)[None, None, :]
    live_y = (ys >= -1.0) & (ys <= fh) & (sidx < grid_h[:, None, None])
    live_x = (xs >= -1.0) & (xs <= fw) & (sidx < grid_w[:, None, None])
    ysc = torch.minimum(torch.clamp_min(ys, 0.0), fh - 1.0)
    xsc = torch.minimum(torch.clamp_min(xs, 0.0), fw - 1.0)
    r = rois.shape[0]
    full = (r, pooled, pooled, max_grid, max_grid)
    k = pooled * pooled * max_grid * max_grid
    yy = ysc[:, :, None, :, None].expand(full).reshape(r, k)
    xx = xsc[:, None, :, None, :].expand(full).reshape(r, k)
    live = (live_y[:, :, None, :, None] & live_x[:, None, :, None, :]).reshape(r, k).float()
    y_max, x_max = (lvl_h - 1)[:, None], (lvl_w - 1)[:, None]
    y0 = torch.minimum(torch.floor(yy).long().clamp_min(0), y_max)
    x0 = torch.minimum(torch.floor(xx).long().clamp_min(0), x_max)
    y1, x1 = torch.minimum(y0 + 1, y_max), torch.minimum(x0 + 1, x_max)
    ly, lx = yy - y0.float(), xx - x0.float()
    hy, hx = 1.0 - ly, 1.0 - lx
    row, b = lvl_w[:, None], base[:, None]
    idx = [b + y0 * row + x0, b + y0 * row + x1, b + y1 * row + x0, b + y1 * row + x1]
    wts = [hy * hx * live, hy * lx * live, ly * hx * live, ly * lx * live]
    inv_count = 1.0 / (grid_h * grid_w).float()
    return idx, wts, inv_count, max_grid


def multilevel_roi_align(features: Sequence[torch.Tensor], rois, batch_idx, levels,
                         level_scales, pooled: int, sampling_ratio: int = 2):
    """features: per level NHWC (B, H_l, W_l, C); rois (R, 4) image coords;
    returns (R, pooled, pooled, C) fp32."""
    channels = features[0].shape[-1]
    idx, wts, inv_count, s = bilinear_taps([f.shape[:3] for f in features], rois, batch_idx,
                                           levels, level_scales, pooled, sampling_ratio)
    flat = torch.cat([f.reshape(-1, channels) for f in features]).float()
    vals = sum(flat[i.reshape(-1)].reshape(i.shape + (channels,)) * w[..., None]
               for i, w in zip(idx, wts))
    r = rois.shape[0]
    return vals.reshape(r, pooled, pooled, s * s, channels).sum(3) * inv_count[:, None, None, None]


def separable_weights(rois, spatial_scale, pooled: int, sampling_ratio: int, height: int,
                      width: int, max_grid: int = 8):
    """Ky (N, P, H) with 1/count folded in, and Kx (N, P, W): each live
    sample lays the hat max(0, 1 - |y - h|) at its clamped coordinate."""
    start_h, start_w, bin_h, bin_w, grid_h, grid_w = roi_geometry(
        rois, spatial_scale, pooled, pooled, sampling_ratio, max_grid)
    if sampling_ratio > 0:
        max_grid = sampling_ratio

    def axis(coords, grid, size):
        dev = coords.device
        live = (coords >= -1.0) & (coords <= size) & (
            torch.arange(max_grid, device=dev)[None, None, :] < grid[:, None, None])
        yc = torch.clamp(coords, 0.0, size - 1.0)
        h = torch.arange(size, dtype=torch.float32, device=dev)
        hat = torch.clamp_min(1.0 - (yc[..., None] - h).abs(), 0.0)
        return torch.where(live[..., None], hat, torch.zeros((), device=dev)).sum(dim=2)

    ky = axis(sample_coords(start_h, bin_h, grid_h, pooled, max_grid), grid_h, height)
    kx = axis(sample_coords(start_w, bin_w, grid_w, pooled, max_grid), grid_w, width)
    return ky * (1.0 / (grid_h * grid_w).float())[:, None, None], kx


def roi_align_matmul(features, rois, pooled: int, spatial_scale: float,
                     sampling_ratio: int = 0, chunk: int = 128):
    """One level: features (H, W, C), rois (N, 4) -> (N, P, P, C) fp32, as
    Ky . F . Kx^T per roi, in chunks of rois."""
    height, width, channels = features.shape
    f = features.float().reshape(height, width * channels)
    outs = []
    for s in range(0, rois.shape[0], chunk):
        ky, kx = separable_weights(rois[s:s + chunk].float(), spatial_scale, pooled,
                                   sampling_ratio, height, width)
        m = ky.shape[0]
        tmp = (ky.reshape(m * pooled, height) @ f).reshape(m, pooled, width, channels)
        outs.append(torch.einsum("nqw,npwc->npqc", kx, tmp))
    return torch.cat(outs) if outs else features.new_zeros((0, pooled, pooled, channels))


def gather_work(level_shapes, rois, batch_idx, levels, level_scales, pooled: int,
                channels: int, sampling_ratio: int = 2):
    """(touched feature pixels, fp32 operations) of a gather-form call: each
    pixel a live tap reads counted once, an FMA per live tap and channel."""
    idx, wts, *_ = bilinear_taps([s[:3] for s in level_shapes], rois, batch_idx, levels,
                                 level_scales, pooled, sampling_ratio)
    live = wts[0] != 0
    pixels = torch.unique(torch.cat([i[live] for i in idx])).numel()
    return pixels, 2 * 4 * int(live.sum()) * channels


def separable_work(rois, spatial_scale, pooled: int, channels: int, height: int, width: int,
                   sampling_ratio: int = 0):
    """(touched feature pixels, fp32 operations) of a one-level call in the
    separable form: per roi, each feature row it touches interpolated along
    x for every bin column, then every bin summed over its rows."""
    ky, kx = separable_weights(rois.float(), spatial_scale, pooled, sampling_ratio, height,
                               width)
    ny = (ky != 0).sum(dim=2).double()
    nx = (kx != 0).sum(dim=2).double()
    rows_any = (ky != 0).any(dim=1)
    cols_any = (kx != 0).any(dim=1)
    rows = rows_any.sum(dim=1).double()
    per_roi = nx.sum(dim=1) * rows + pooled * ny.sum(dim=1)
    touched = (rows_any[:, :, None] & cols_any[:, None, :]).any(dim=0).sum()
    return int(touched), 2.0 * channels * float(per_roi.sum())

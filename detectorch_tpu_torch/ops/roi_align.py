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

``multilevel_roi_align_backward`` is its feature gradient, scattering
through the same taps (the counterpart of JAX's gather VJP and of
``multilevel_roi_align_slab_grad``).

``roi_align_matmul`` is the C4 form (one level, the adaptive grid of
``sampling_ratio`` 0): bin-averaged bilinear sampling is separable per axis,
so each roi's output is Ky · F · Kxᵀ with dense per-axis hat weights, 1/count
folded into Ky; ``roi_align_matmul_backward`` is its feature gradient,
Kyᵀ · g · Kx summed over the rois. Port of JAX's ``roi_align_matmul``,
chunked over rois as it is. The gather form pads every bin to max_grid²
taps, which at C4's 1024 channels is tens of GB for a hundred rois.

These are the plain versions that sit beside the CUDA kernels
(``ops/cuda/roi_align_kernel.py``): CPU tensors run them, and the kernels
are held to them on the card.
"""

from __future__ import annotations

import contextlib
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


def _bilinear_taps(level_shapes, rois, batch_idx, levels, level_scales, pooled_h: int,
                   pooled_w: int, sampling_ratio: int, max_grid: int):
    """The four bilinear taps of every sample of every roi, over the levels
    stacked row-wise into one (sum_l B*H_l*W_l, C) table.

    level_shapes: per level (B, H_l, W_l). Returns (idx, wts, inv_count,
    sizes, max_grid): idx and wts are lists of four (R, PH*PW*S*S) tensors
    — flat table rows and weights (hy*hx etc. times the live mask) of the
    taps (y0,x0), (y0,x1), (y1,x0), (y1,x1), samples ordered (ph, pw, iy,
    ix); inv_count (R,) is 1/(grid_h*grid_w); sizes the rows per level."""
    dev = rois.device
    shapes = torch.tensor([list(s[1:3]) for s in level_shapes],
                          dtype=torch.int64, device=dev)  # (L, 2)
    sizes = [int(s[0]) * int(s[1]) * int(s[2]) for s in level_shapes]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                           dtype=torch.int64, device=dev)

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
    k = pooled_h * pooled_w * max_grid * max_grid
    yy = ysc[:, :, None, :, None].expand(full).reshape(r, k)
    xx = xsc[:, None, :, None, :].expand(full).reshape(r, k)
    live = (live_y[:, :, None, :, None] & live_x[:, None, :, None, :]).reshape(r, k).float()

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
    b = base[:, None]
    idx = [b + y0 * row + x0, b + y0 * row + x1, b + y1 * row + x0, b + y1 * row + x1]
    wts = [hy * hx * live, hy * lx * live, ly * hx * live, ly * lx * live]
    inv_count = 1.0 / (grid_h * grid_w).float()
    return idx, wts, inv_count, sizes, max_grid


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
    channels = feature_list[0].shape[-1]
    idx, wts, inv_count, _, s = _bilinear_taps(
        [f.shape[:3] for f in feature_list], rois, batch_idx, levels, level_scales,
        pooled_h, pooled_w, sampling_ratio, max_grid)
    flat = torch.cat([f.reshape(-1, channels) for f in feature_list]).float()

    def take(i):
        return flat[i.reshape(-1)].reshape(i.shape + (channels,))

    vals = (
        take(idx[0]) * wts[0][..., None]
        + take(idx[1]) * wts[1][..., None]
        + take(idx[2]) * wts[2][..., None]
        + take(idx[3]) * wts[3][..., None]
    )
    r = rois.shape[0]
    summed = vals.reshape(r, pooled_h, pooled_w, s * s, channels).sum(dim=3)
    return summed * inv_count[:, None, None, None]


def multilevel_roi_align_backward(
    g,
    feature_shapes,
    rois,
    batch_idx,
    levels,
    level_scales: Sequence[float],
    pooled_h: int,
    pooled_w: int,
    sampling_ratio: int = 2,
    max_grid: int = 8,
    out_dtype: torch.dtype = torch.float32,
):
    """Feature gradient of ``multilevel_roi_align``, exact for every roi.

    g: (R, PH, PW, C) cotangent; feature_shapes: per level (B, H_l, W_l, C).
    Each roi scatter-adds (``index_add_``, fp32) g times the same four
    bilinear tap weights and 1/count that the forward gathers with; the
    sum is rounded once to `out_dtype`. Returns per level (B, H_l, W_l, C).
    """
    channels = int(feature_shapes[0][-1])
    idx, wts, inv_count, sizes, s = _bilinear_taps(
        [tuple(f[:3]) for f in feature_shapes], rois, batch_idx, levels, level_scales,
        pooled_h, pooled_w, sampling_ratio, max_grid)
    r = rois.shape[0]
    gs = g.float() * inv_count[:, None, None, None]
    gs = gs[:, :, :, None, None, :].expand(r, pooled_h, pooled_w, s, s, channels) \
        .reshape(r, pooled_h * pooled_w * s * s, channels)
    flat = torch.zeros((sum(sizes), channels), dtype=torch.float32, device=g.device)
    for i, w in zip(idx, wts):
        flat.index_add_(0, i.reshape(-1), (gs * w[..., None]).reshape(-1, channels))
    return [part.reshape(tuple(shape)).to(out_dtype)
            for part, shape in zip(flat.split(sizes), feature_shapes)]


# JAX's roi_align_matmul tiers that the port computes exactly: both run the
# fp32 form ('high' is bf16_3x on a TPU; JAX's CPU path computes fp32 too)
MATMUL_PRECISIONS = ("high", "highest")


def check_matmul_precision(precision: str) -> None:
    """The C4 RoIAlign is exact fp32; the 'bf16' tier (bf16 intermediate and
    output) is refused rather than run at another precision."""
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(f"roi_align_precision {precision!r} is not supported by the port; "
                         f"supported: {MATMUL_PRECISIONS}")


def _axis_weights_dense(coords, grid, size: int, max_grid: int):
    """Dense per-axis weights (N, pooled, size): each live sample lays the hat
    max(0, 1 - |y - h|) over the axis at its clamped coordinate y, summed
    over the bin's samples. Samples outside [-1, size] or past the adaptive
    grid add nothing; a sample clamped onto the last row puts weight 1
    there, as the caffe2 taps do."""
    dev = coords.device
    live = (coords >= -1.0) & (coords <= size) & (
        torch.arange(max_grid, device=dev)[None, None, :] < grid[:, None, None])
    yc = torch.clamp(coords, 0.0, size - 1.0)
    h = torch.arange(size, dtype=torch.float32, device=dev)
    hat = torch.clamp_min(1.0 - (yc[..., None] - h).abs(), 0.0)  # (N, P, S, size)
    return torch.where(live[..., None], hat, torch.zeros((), device=dev)).sum(dim=2)


def separable_weights(rois, spatial_scale, pooled_h: int, pooled_w: int, sampling_ratio: int,
                      max_grid: int, height: int, width: int):
    """Per-roi interpolation matrices of one level: Ky (N, PH, H) with
    1/(grid_h*grid_w) folded in, and Kx (N, PW, W). rois (N, 4) image-space
    xyxy fp32."""
    start_h, start_w, bin_h, bin_w, grid_h, grid_w = roi_geometry(
        rois, spatial_scale, pooled_h, pooled_w, sampling_ratio, max_grid)
    if sampling_ratio > 0:
        max_grid = sampling_ratio
    ys = sample_coords(start_h, bin_h, grid_h, pooled_h, max_grid)
    xs = sample_coords(start_w, bin_w, grid_w, pooled_w, max_grid)
    ky = _axis_weights_dense(ys, grid_h, height, max_grid)
    kx = _axis_weights_dense(xs, grid_w, width, max_grid)
    inv_count = 1.0 / (grid_h * grid_w).float()
    return ky * inv_count[:, None, None], kx


@contextlib.contextmanager
def _fp32_matmul():
    """The separable products in true fp32: no TF32 on the card."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _batched_weights(rois, spatial_scale, pooled_h, pooled_w, sampling_ratio, max_grid,
                     height, width):
    bsz, n = rois.shape[:2]
    ky, kx = separable_weights(rois.reshape(bsz * n, 4).float(), spatial_scale, pooled_h,
                               pooled_w, sampling_ratio, max_grid, height, width)
    return ky.reshape(bsz, n, pooled_h, height), kx.reshape(bsz, n, pooled_w, width)


def roi_align_matmul(features, rois, pooled_h: int, pooled_w: int, spatial_scale: float,
                     sampling_ratio: int = 0, max_grid: int = 8, precision: str = "highest",
                     roi_chunk: int = 128):
    """Separable RoIAlign on one feature level, exact fp32.

    features (B, H, W, C) with rois (B, N, 4), or (H, W, C) with (N, 4), as
    JAX's; returns (B, N, PH, PW, C) (or (N, PH, PW, C)) fp32. Per chunk of
    `roi_chunk` rois (0: one chunk) the (B, chunk, PH, W, C) intermediate
    Ky · F is formed, then contracted with Kx; each roi's output does not
    depend on the chunking. precision 'high' and 'highest' both compute
    fp32 (``check_matmul_precision``)."""
    check_matmul_precision(precision)
    single = features.dim() == 3
    if single:
        features, rois = features[None], rois[None]
    bsz, height, width, channels = features.shape
    n = rois.shape[1]
    ky, kx = _batched_weights(rois, spatial_scale, pooled_h, pooled_w, sampling_ratio,
                              max_grid, height, width)
    f = features.float().reshape(bsz, height, width * channels)
    chunk = n if roi_chunk <= 0 else roi_chunk
    outs = [torch.zeros((bsz, 0, pooled_h, pooled_w, channels), device=features.device)]
    with _fp32_matmul():
        for s in range(0, n, max(chunk, 1)):
            kyc, kxc = ky[:, s:s + chunk], kx[:, s:s + chunk]
            m = kyc.shape[1]
            # (B, m*PH, H) x (B, H, W*C) -> (B*m, PH, W, C)
            tmp = torch.bmm(kyc.reshape(bsz, m * pooled_h, height), f) \
                .reshape(bsz * m, pooled_h, width, channels)
            # (B*m, PW, W) x (B*m, PH, W, C) -> (B*m, PH, PW, C)
            out = torch.einsum("nqw,npwc->npqc", kxc.reshape(bsz * m, pooled_w, width), tmp)
            outs.append(out.reshape(bsz, m, pooled_h, pooled_w, channels))
    out = torch.cat(outs, dim=1)
    return out[0] if single else out


def roi_align_matmul_backward(g, feature_shape, rois, pooled_h: int, pooled_w: int,
                              spatial_scale: float, sampling_ratio: int = 0, max_grid: int = 8,
                              roi_chunk: int = 128, out_dtype: torch.dtype = torch.float32):
    """Feature gradient of ``roi_align_matmul``: dF = sum over rois of
    Kyᵀ · g · Kx, in fp32, rounded once to `out_dtype`.

    g (B, N, PH, PW, C) cotangent; feature_shape (B, H, W, C); rois
    (B, N, 4). Returns (B, H, W, C)."""
    bsz, height, width, channels = (int(d) for d in feature_shape)
    n = rois.shape[1]
    ky, kx = _batched_weights(rois, spatial_scale, pooled_h, pooled_w, sampling_ratio,
                              max_grid, height, width)
    acc = torch.zeros((bsz, height, width * channels), dtype=torch.float32, device=g.device)
    chunk = n if roi_chunk <= 0 else roi_chunk
    with _fp32_matmul():
        for s in range(0, n, max(chunk, 1)):
            gc, kyc, kxc = g[:, s:s + chunk].float(), ky[:, s:s + chunk], kx[:, s:s + chunk]
            m = kyc.shape[1]
            # (B*m, PH, PW, C) x (B*m, PW, W) -> (B*m, PH, W, C)
            t = torch.einsum("npqc,nqw->npwc", gc.reshape(bsz * m, pooled_h, pooled_w, channels),
                             kxc.reshape(bsz * m, pooled_w, width))
            # (B, H, m*PH) x (B, m*PH, W*C)
            acc += torch.bmm(kyc.reshape(bsz, m * pooled_h, height).transpose(1, 2),
                             t.reshape(bsz, m * pooled_h, width * channels))
    return acc.reshape(bsz, height, width, channels).to(out_dtype)

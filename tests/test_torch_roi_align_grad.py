"""The port's RoIAlign feature gradient against the JAX package, the backward
kernel's algorithm, and the differentiable RoIAlign used by training.

The plain backward (``ops/roi_align.multilevel_roi_align_backward``) is the
version the CUDA backward kernel is held to on the card; here it is held to
``jax.vjp`` of JAX's exact gather RoIAlign for every roi (out-of-slab,
degenerate and out-of-image rois included), to the Pallas slab backward run
in interpret mode on rois that fit its slab, and to torch autograd of the
plain forward.

Tolerance: max|d| <= 1e-5 * max|reference| throughout. Every version sums
the same fp32 products of g, the bilinear weights and 1/count; they differ
only in summation order (scatter order, per-roi matmuls, or autograd's
index_put), which moves a sum of a few dozen O(1) terms by ~1e-7 of its
scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.ops.pallas.roi_align_kernel import multilevel_roi_align_slab_grad, slab_fits
from detectorch_tpu.ops.roi_align import multilevel_roi_align as jax_roi_align
from detectorch_tpu_torch.ops.cuda.roi_align_kernel import (
    TILE,
    roi_align_bwd,
    roi_geometry_f32,
    roi_tile_lists,
    tile_tables,
)
from detectorch_tpu_torch.ops.roi_align import (
    multilevel_roi_align,
    multilevel_roi_align_backward,
)
from detectorch_tpu_torch.ops.roi_align_fused import (
    ROI_ALIGN_IMPLS,
    check_roi_align_impl,
    roi_align_fused,
)
from tests.test_torch_roi_align import SCALES, _pyramid, _rois

REL = 1e-5


def _shapes(feats):
    return [f.shape for f in feats]


def _port_bwd(g, feats, rois, bidx, levels, pooled, sampling_ratio=2, out_dtype=torch.float32):
    return multilevel_roi_align_backward(
        torch.from_numpy(g), _shapes(feats), torch.from_numpy(rois), torch.from_numpy(bidx),
        torch.from_numpy(levels), SCALES, pooled, pooled, sampling_ratio,
        out_dtype=out_dtype)


def _assert_close(got, exp):
    scale = max(float(np.abs(e).max()) for e in exp)
    assert scale > 0.1  # the comparison saw real gradients
    for a, e in zip(got, exp):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.shape == e.shape
        err = float(np.abs(a - e).max())
        assert err <= REL * scale, (err, scale)


@pytest.mark.parametrize("pooled,sampling_ratio", [(7, 2), (14, 2), (7, 0)])
def test_plain_backward_matches_jax_vjp(rng, pooled, sampling_ratio):
    feats = _pyramid(rng, batch=2)
    rois, bidx, levels = _rois(rng, 2, 24)
    g = rng.randn(len(rois), pooled, pooled, 8).astype(np.float32)
    got = _port_bwd(g, feats, rois, bidx, levels, pooled, sampling_ratio)
    exp = [np.zeros_like(f) for f in feats]
    for b in range(2):
        sel = bidx == b

        def pooled_fn(fl, sel=sel):
            return jax_roi_align(fl, jnp.asarray(rois[sel]), jnp.asarray(levels[sel]), SCALES,
                                 pooled, pooled, sampling_ratio)

        _, vjp = jax.vjp(pooled_fn, [jnp.asarray(f[b]) for f in feats])
        (gf,) = vjp(jnp.asarray(g[sel]))
        for e, gl in zip(exp, gf):
            e[b] = np.asarray(gl)
    _assert_close(got, exp)


@pytest.mark.parametrize("pooled", [7, 14])
def test_plain_backward_matches_slab_grad_interpret(rng, pooled):
    feats = _pyramid(rng, batch=1)
    rois, bidx, levels = _rois(rng, 1, 24)
    fits = np.asarray(slab_fits(rois, levels, [f.shape[1:3] for f in feats], SCALES,
                                pooled, pooled, 2, slab=32))
    assert fits.sum() >= 12
    rois, bidx, levels = rois[fits], bidx[fits], levels[fits]
    g = rng.randn(len(rois), pooled, pooled, 8).astype(np.float32)
    got = _port_bwd(g, feats, rois, bidx, levels, pooled)
    exp = multilevel_roi_align_slab_grad(g, [f.shape[1:] for f in feats], rois, levels, SCALES,
                                         pooled, pooled, 2, slab=32, interpret=True)
    _assert_close(got, [np.asarray(e)[None] for e in exp])


def test_plain_backward_matches_autograd(rng):
    feats = _pyramid(rng, batch=2)
    rois, bidx, levels = _rois(rng, 2, 30)
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    args = (torch.from_numpy(rois), torch.from_numpy(bidx), torch.from_numpy(levels), SCALES,
            14, 14, 2)
    out = multilevel_roi_align(tf, *args)
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    exp = torch.autograd.grad(out, tf, g)
    got = multilevel_roi_align_backward(g, _shapes(feats), *args)
    _assert_close(got, [e.numpy() for e in exp])


def test_plain_backward_bf16_is_fp32_rounded_once(rng):
    feats = _pyramid(rng, batch=2)
    rois, bidx, levels = _rois(rng, 2, 20)
    g = rng.randn(len(rois), 7, 7, 8).astype(np.float32)
    f32 = _port_bwd(g, feats, rois, bidx, levels, 7)
    bf16 = _port_bwd(g, feats, rois, bidx, levels, 7, out_dtype=torch.bfloat16)
    for a, b in zip(bf16, f32):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))


def test_plain_versions_take_zero_rois():
    feats = [torch.randn(2, 10, 16, 8), torch.randn(2, 5, 8, 8)]
    rois = torch.zeros((0, 4))
    idx = torch.zeros((0,), dtype=torch.int32)
    out = multilevel_roi_align(feats, rois, idx, idx, SCALES[:2], 7, 7, 2)
    assert out.shape == (0, 7, 7, 8)
    grads = multilevel_roi_align_backward(torch.zeros((0, 7, 7, 8)), _shapes(feats), rois, idx,
                                          idx, SCALES[:2], 7, 7, 2)
    assert [tuple(g.shape) for g in grads] == _shapes(feats)
    assert not any(g.any() for g in grads)


def _coord(start, bin_size, grid, p, i):
    """The kernels' sample_coord, in float32 step by step."""
    f = np.float32
    return f(f(start + f(f(p) * bin_size)) + f(f(f(i) + f(0.5)) * bin_size) / f(grid))


def _axis_weight(start, bin_size, grid, p, row, size):
    """The backward kernel's axis_weight."""
    f = np.float32
    if row >= size:
        return f(0)
    w = f(0)
    for i in range(grid):
        y = _coord(start, bin_size, grid, p, i)
        if y < -1 or y > size:
            continue
        y = min(max(y, f(0)), f(size - 1))
        y0 = int(np.floor(y))
        y1 = min(y0 + 1, size - 1)
        ly = f(y - f(y0))
        if row == y0:
            w = f(w + f(f(1) - ly))
        if row == y1:
            w = f(w + ly)
    return w


def _tile_span(start, bin_size, grid, pooled, size):
    """The backward kernel's tile_span: the tiles the roi's taps can reach."""
    top = np.float32(size - 1)
    first = min(max(_coord(start, bin_size, grid, 0, 0), 0), top)
    last = min(max(_coord(start, bin_size, grid, pooled - 1, grid - 1), 0), top)
    lo = max(int(np.floor(first)) - 1, 0)
    hi = min(int(np.floor(last)) + 2, size - 1)
    return lo // TILE, hi // TILE


def _emulate_kernel(g, shapes, rois, bidx, levels, pooled, sampling_ratio):
    """The backward kernels' algorithm on the CPU: the per-tile roi lists of
    the wrapper's mirror (count, scan, fill, ascending); per tile and listed
    roi, Ky (with 1/count) and Kx over the tile's rows and columns; each
    column of bins is folded first, h[y, pw] = sum over ph of Ky[ph, y] *
    g[roi, ph, pw], then Kx[pw, x] * h[y, pw] is added to pixel (y, x)."""
    f = np.float32
    tiles_x, tiles_per_image, tile_base = tile_tables([s[:3] for s in shapes])
    starts, lists = roi_tile_lists(shapes, torch.from_numpy(rois), torch.from_numpy(bidx),
                                   torch.from_numpy(levels), SCALES, pooled, pooled,
                                   sampling_ratio)
    outs = [np.zeros(s, np.float32) for s in shapes]
    inv = f(f(1) / f(sampling_ratio * sampling_ratio))
    for t in range(tile_base[-1]):
        lvl = max(i for i in range(len(shapes)) if tile_base[i] <= t)
        b, t_img = divmod(t - tile_base[lvl], tiles_per_image[lvl])
        ty, tx = divmod(t_img, tiles_x[lvl])
        height, width = shapes[lvl][1:3]
        acc = np.zeros((TILE, TILE, shapes[0][-1]), np.float32)
        for r in lists[starts[t]:starts[t + 1]]:
            sh, sw, bh, bw, gh, gw = roi_geometry_f32(rois[r], SCALES[lvl], pooled, pooled,
                                                      sampling_ratio)
            ky = np.array([[f(_axis_weight(sh, bh, gh, p, ty * TILE + y, height) * inv)
                            for y in range(TILE)] for p in range(pooled)], np.float32)
            kx = np.array([[_axis_weight(sw, bw, gw, p, tx * TILE + x, width)
                            for x in range(TILE)] for p in range(pooled)], np.float32)
            h = np.einsum("py,pqc->yqc", ky, g[r])
            acc += np.einsum("qx,yqc->yxc", kx, h)
        hh, ww = min(TILE, height - ty * TILE), min(TILE, width - tx * TILE)
        outs[lvl][b, ty * TILE:ty * TILE + hh, tx * TILE:tx * TILE + ww] = acc[:hh, :ww]
    return outs


LIST_SHAPES = [(2, 40, 64, 8), (2, 20, 32, 8), (2, 10, 16, 8), (2, 5, 8, 8)]


def test_backward_kernel_tiles_and_algorithm(rng):
    """The kernels' tile lists and per-tile separable sums, emulated on the
    CPU, give the plain backward: no tap lies outside the tiles whose list
    holds the roi. With an out-of-range level, an empty level, and R = 0."""
    rois, bidx, levels = _rois(rng, 2, 16)
    rois = rois * 0.5  # a 160x256 image for these levels
    levels = np.where(levels == 3, 2, levels).astype(np.int32)  # the coarsest level is empty
    levels[5] = 9  # out of range: no tile lists it, and it adds nothing
    g = rng.randn(len(rois), 7, 7, 8).astype(np.float32)
    got = _emulate_kernel(g, LIST_SHAPES, rois, bidx, levels, 7, 2)
    keep = levels < 4
    exp = multilevel_roi_align_backward(
        torch.from_numpy(g[keep]), LIST_SHAPES, torch.from_numpy(rois[keep]),
        torch.from_numpy(bidx[keep]), torch.from_numpy(levels[keep]), SCALES, 7, 7, 2)
    assert not got[3].any()
    _assert_close(got, [e.numpy() for e in exp])

    empty = _emulate_kernel(g[:0], LIST_SHAPES, rois[:0], bidx[:0], levels[:0], 7, 2)
    assert not any(e.any() for e in empty)


def _list_case(rng, case):
    """(rois, bidx, levels) of one list-builder case, for LIST_SHAPES (a
    160x256 image)."""
    rois, bidx, levels = _rois(rng, 2, 16)
    rois = (rois * 0.5).astype(np.float32)
    if case == "cluster300":
        # 300 small rois jittered around one spot: one P2 tile lists them all
        base = np.array([100.0, 60.0, 112.0, 70.0], np.float32)
        cluster = (base + rng.uniform(-1.5, 1.5, (300, 4))).astype(np.float32)
        rois = np.concatenate([rois, cluster])
        bidx = np.concatenate([bidx, np.ones(300, np.int32)])
        levels = np.concatenate([levels, np.zeros(300, np.int32)])
    elif case == "out_of_range_level":
        levels = levels.copy()
        levels[::3] = 9
        bidx = bidx.copy()
        bidx[1] = 5  # an image out of range too
    elif case == "empty_level":
        levels = np.where(levels == 3, 2, levels).astype(np.int32)
    elif case == "no_rois":
        rois, bidx, levels = rois[:0], bidx[:0], levels[:0]
    return rois, bidx.astype(np.int32), levels.astype(np.int32)


@pytest.mark.parametrize("pooled", [7, 14])
@pytest.mark.parametrize("case", ["cluster300", "out_of_range_level", "empty_level", "no_rois"])
def test_tile_roi_lists(rng, case, pooled):
    """The list builder's mirror: each tile's list holds, in ascending
    order, exactly the rois whose tile span (computed here independently)
    covers it, and among them every roi whose plain gradient is non-zero on
    that tile; rois of a level or image out of range are in no list."""
    rois, bidx, levels = _list_case(rng, case)
    starts, lists = roi_tile_lists(LIST_SHAPES, torch.from_numpy(rois), torch.from_numpy(bidx),
                                   torch.from_numpy(levels), SCALES, pooled, pooled, 2)
    tiles_x, tiles_per_image, tile_base = tile_tables([s[:3] for s in LIST_SHAPES])
    assert len(starts) == tile_base[-1] + 1 and starts[0] == 0 and starts[-1] == len(lists)
    assert np.all(np.diff(starts) >= 0)
    f = np.float32
    expected = [[] for _ in range(tile_base[-1])]  # by span, in ascending roi order
    for r, (x1, y1, x2, y2) in enumerate(rois):
        lvl, b = int(levels[r]), int(bidx[r])
        if not (0 <= lvl < len(LIST_SHAPES) and 0 <= b < LIST_SHAPES[0][0]):
            continue
        s = f(SCALES[lvl])
        sw, sh = f(x1 * s), f(y1 * s)
        bw = f(max(f(f(x2 * s) - sw), f(1)) / f(pooled))
        bh = f(max(f(f(y2 * s) - sh), f(1)) / f(pooled))
        ty0, ty1 = _tile_span(sh, bh, 2, pooled, LIST_SHAPES[lvl][1])
        tx0, tx1 = _tile_span(sw, bw, 2, pooled, LIST_SHAPES[lvl][2])
        first = tile_base[lvl] + b * tiles_per_image[lvl]
        for ty in range(ty0, ty1 + 1):
            for tx in range(tx0, tx1 + 1):
                expected[first + ty * tiles_x[lvl] + tx].append(r)
    for t in range(tile_base[-1]):
        assert list(lists[starts[t]:starts[t + 1]]) == expected[t], t
    # every roi whose plain gradient touches a tile is in that tile's list
    keep = (levels >= 0) & (levels < len(LIST_SHAPES)) & (bidx >= 0) & (bidx < 2)
    for r in np.flatnonzero(keep):
        grads = multilevel_roi_align_backward(
            torch.ones((1, pooled, pooled, 8)), LIST_SHAPES, torch.from_numpy(rois[r:r + 1]),
            torch.from_numpy(bidx[r:r + 1]), torch.from_numpy(levels[r:r + 1]), SCALES,
            pooled, pooled, 2)
        lvl = int(levels[r])
        _, ys, xs = np.nonzero(grads[lvl].numpy().any(axis=-1))
        first = tile_base[lvl] + int(bidx[r]) * tiles_per_image[lvl]
        for t in set(first + (ys // TILE) * tiles_x[lvl] + xs // TILE):
            assert r in lists[starts[t]:starts[t + 1]], (r, t)
    if case == "cluster300":
        assert np.diff(starts).max() >= 300
    if case == "empty_level":
        assert starts[tile_base[3]] == starts[-1]  # no pair on the coarsest level
    if case == "no_rois":
        assert len(lists) == 0


def test_fused_gradients_are_the_plain_backward(rng):
    feats = _pyramid(rng, batch=2)
    rois, bidx, levels = _rois(rng, 2, 20)
    for dtype in (torch.float32, torch.bfloat16):
        tf = [torch.from_numpy(f).to(dtype).requires_grad_() for f in feats]
        args = (torch.from_numpy(rois), torch.from_numpy(bidx), torch.from_numpy(levels),
                SCALES, 7, 7, 2)
        out = roi_align_fused(tf, *args)
        assert torch.equal(out, multilevel_roi_align([t.detach() for t in tf], *args))
        g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
        got = torch.autograd.grad(out, tf, g)
        exp = multilevel_roi_align_backward(g, _shapes(feats), *args, out_dtype=dtype)
        for a, e in zip(got, exp):
            assert a.dtype == dtype and torch.equal(a, e)
    assert roi_align_bwd.launches == 0  # the plain version is not a launch


def test_backward_never_falls_back_off_cpu():
    # tensors that lie neither on the CPU nor on a CUDA card are refused,
    # not computed by the plain version
    feats = [torch.empty((1, 8, 8, 8), device="meta", requires_grad=True)]
    rois = torch.empty((2, 4), device="meta")
    idx = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_bwd(torch.empty((2, 7, 7, 8), device="meta"), [(1, 8, 8, 8)], rois, idx, idx,
                      (0.25,), 7, 7)
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_fused(feats, rois, idx, idx, (0.25,), 7, 7)
    with pytest.raises(ValueError, match="several devices"):
        roi_align_bwd(torch.zeros((2, 7, 7, 8)), [(1, 8, 8, 8)], rois, idx, idx, (0.25,), 7, 7)


@pytest.mark.parametrize("impl,bwd_precision", [
    ("pallas-zero", "bf16"), ("pallas-mm", "bf16"), ("pallas-mm", "high"), ("slab", "bf16")])
def test_refused_roi_align_impls(impl, bwd_precision):
    with pytest.raises(ValueError, match="roi_align_impl"):
        check_roi_align_impl(impl, bwd_precision)


def test_exact_roi_align_impls_are_accepted():
    for impl in ("gather", "pallas", "pallas-slab"):
        check_roi_align_impl(impl, "bf16")
    check_roi_align_impl("pallas-mm", "highest")
    assert "pallas-slab" in ROI_ALIGN_IMPLS

"""The port's RoIAlign against the JAX package, its wrapper's dispatch, and
the forward kernel's tap plan.

The port's plain PyTorch RoIAlign (``ops/roi_align.multilevel_roi_align``)
is the version the CUDA kernel is held to on the card; here it is held to
JAX's exact gather (``detectorch_tpu.ops.roi_align.multilevel_roi_align``)
and to the Pallas TPU kernel run in interpret mode.

Tolerances: against the JAX gather, atol 1e-5 — both compute the same fp32
sample geometry and sum at most 4x4 weighted taps of |v| < 5 per bin, so
they differ only by summation order. Against the Pallas kernel, atol 1e-4,
as tests/test_pallas_roi_align.py holds that kernel to the gather: it sums
by hat-matrix matmuls over a whole slab.

The forward kernel decides per roi which feature rows and columns it loads
for each bin row and bin column, and by which summed weights
(``ops/cuda/roi_align_kernel.fwd_tap_plan`` mirrors that decision in numpy).
Every live tap of the plain version must lie in the plan, and the plan's
separable sum, inv_count * Ky . F . Kx^T, must give the plain version's
values: atol 1e-5, as on the card (the same fp32 weights summed per row and
column, another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.ops.pallas.roi_align_kernel import multilevel_roi_align_pallas
from detectorch_tpu.ops.roi_align import multilevel_roi_align as jax_roi_align
from detectorch_tpu_torch import config as torch_config
from detectorch_tpu_torch.models.detector import make_inference_fn
from detectorch_tpu_torch.ops.cuda.roi_align_kernel import (
    RoIAlignForward,
    check_precision,
    fwd_tap_plan,
    roi_align_fwd,
)
from detectorch_tpu_torch.ops.fpn_levels import map_rois_to_fpn_levels
from detectorch_tpu_torch.ops.roi_align import _bilinear_taps, multilevel_roi_align

SCALES = (0.25, 0.125, 0.0625, 0.03125)
H, W = 320, 512  # P2 is 80x128: wider than the TPU kernel's 64-pixel slab


def _pyramid(rng, batch, c=8):
    return [rng.randn(batch, H // s, W // s, c).astype(np.float32) for s in (4, 8, 16, 32)]


def _rois(rng, batch, n):
    """(batch*n, 4) rois, their image index and a level each: random boxes
    plus rois partly outside the image, degenerate (x2 < x1), tiny, fully
    outside, and extreme-aspect rois that overflow the 64-pixel slab."""
    x1 = rng.uniform(-0.05 * W, W, (batch, n))
    y1 = rng.uniform(-0.05 * H, H, (batch, n))
    bw = np.exp(rng.uniform(0, 6, (batch, n))) * 2.0
    bh = bw * np.exp(rng.uniform(-1.5, 1.5, (batch, n)))
    rois = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    edge = np.array([
        [-40, -30, 120, 90],                  # partly outside, top-left
        [W - 60, H - 50, W + 80, H + 70],     # partly outside, bottom-right
        [300, 200, 250, 150],                 # degenerate: x2 < x1
        [0, 100, W - 1, 108],                 # 512 x 9: overflows the slab
        [200, 0, 206, H - 1],                 # 7 x 320
        [0, 0, W - 1, H - 1],                 # whole image
        [100, 100, 100.5, 100.5],             # tiny
        [-500, -500, -400, -450],             # fully outside
    ], np.float32)
    rois[:, :len(edge)] = edge
    levels = rng.randint(0, 4, (batch, n)).astype(np.int32)
    levels[:, :len(edge)] = [0, 1, 0, 0, 0, 2, 0, 3]
    bidx = np.repeat(np.arange(batch, dtype=np.int32), n)
    return rois.reshape(-1, 4), bidx, levels.reshape(-1)


def _jax_per_image(fn, feats, rois, bidx, levels, **kw):
    out = None
    for b in range(feats[0].shape[0]):
        sel = bidx == b
        got = fn([f[b] for f in feats], rois[sel], levels[sel], **kw)
        got = np.asarray(got[0] if isinstance(got, tuple) else got)
        if out is None:
            out = np.zeros((len(rois),) + got.shape[1:], np.float32)
        out[sel] = got
    return out


def _port(feats, rois, bidx, levels, pooled, sampling_ratio, dtype=torch.float32):
    return multilevel_roi_align(
        [torch.from_numpy(f).to(dtype) for f in feats], torch.from_numpy(rois),
        torch.from_numpy(bidx), torch.from_numpy(levels), SCALES, pooled, pooled,
        sampling_ratio)


@pytest.mark.parametrize("pooled,sampling_ratio", [(7, 2), (14, 2), (7, 0), (14, 0)])
def test_plain_matches_jax_gather(rng, pooled, sampling_ratio):
    feats = _pyramid(rng, batch=3)
    rois, bidx, levels = _rois(rng, 3, 40)
    got = _port(feats, rois, bidx, levels, pooled, sampling_ratio)
    assert got.shape == (len(rois), pooled, pooled, 8) and got.dtype == torch.float32
    exp = _jax_per_image(jax_roi_align, feats, rois, bidx, levels, level_scales=SCALES,
                         pooled_h=pooled, pooled_w=pooled, sampling_ratio=sampling_ratio)
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=1e-5)
    assert np.abs(exp).max() > 0.5  # the comparison saw real values


def test_plain_bf16_features_match_jax(rng):
    # bf16 features are widened to fp32 exactly by both before sampling
    feats = _pyramid(rng, batch=2)
    rois, bidx, levels = _rois(rng, 2, 30)
    got = _port(feats, rois, bidx, levels, 7, 2, dtype=torch.bfloat16)
    exp = _jax_per_image(jax_roi_align, [jnp.asarray(f, jnp.bfloat16) for f in feats],
                         rois, bidx, levels, level_scales=SCALES, pooled_h=7, pooled_w=7,
                         sampling_ratio=2)
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pooled", [7, 14])
def test_plain_matches_pallas_interpret(rng, pooled):
    feats = _pyramid(rng, batch=1)
    rois, bidx, levels = _rois(rng, 1, 24)
    got = _port(feats, rois, bidx, levels, pooled, 2).numpy()
    out, fits = multilevel_roi_align_pallas(
        [f[0] for f in feats], rois, levels, SCALES, pooled, pooled, sampling_ratio=2,
        slab=32, interpret=True)
    fits = np.asarray(fits)
    assert fits.sum() >= 16 and not fits[3]  # the 512 x 9 roi overflows the slab
    np.testing.assert_allclose(got[fits], np.asarray(out)[fits], rtol=1e-4, atol=1e-4)


def test_wrapper_runs_plain_version_on_cpu(rng):
    feats = _pyramid(rng, batch=2)
    rois, bidx, levels = _rois(rng, 2, 20)
    args = ([torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
            torch.from_numpy(bidx), torch.from_numpy(levels), SCALES, 7, 7, 2)
    wrapper = RoIAlignForward()
    got = wrapper(*args)
    assert torch.equal(got, multilevel_roi_align(*args))
    assert wrapper.launches == 0  # the plain version is not a launch


def test_wrapper_never_falls_back_off_cpu(rng):
    # a tensor that lies neither on the CPU nor on a CUDA card is refused,
    # not computed by the plain version
    feats = [torch.empty((1, 8, 8, 8), device="meta")]
    rois = torch.empty((2, 4), device="meta")
    idx = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_fwd(feats, rois, idx, idx, (0.25,), 7, 7)
    with pytest.raises(ValueError, match="several devices"):
        roi_align_fwd([torch.zeros((1, 8, 8, 8))], rois, idx, idx, (0.25,), 7, 7)


@pytest.mark.parametrize("precision", ["bf16", "bf16x3", "fast"])
def test_precision_other_than_exact_raises(precision):
    with pytest.raises(ValueError, match="roi_align_fwd_precision"):
        check_precision(precision)
    cfg = torch_config.PRESETS["e2e_mask_rcnn_R-50-FPN_2x"].replace(
        roi_align_fwd_precision=precision)
    with pytest.raises(ValueError, match="roi_align_fwd_precision"):
        make_inference_fn(cfg, None)


def _smoke_rois(batch, n, height, width):
    """chip_smoke.make_rois (random rois plus its edge cases: extreme aspect,
    partly and fully outside, degenerate, tiny, whole image) at the main
    path's 832x1344, with the levels the detector maps them to."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    gen = torch.Generator()
    gen.manual_seed(0)
    rois = cs.make_rois(gen, batch, n, height, width, torch.device("cpu")).reshape(-1, 4)
    levels = (map_rois_to_fpn_levels(rois) - 2).to(torch.int32)
    bidx = torch.arange(batch, dtype=torch.int32).repeat_interleave(n)
    return rois.contiguous().numpy(), bidx.numpy(), levels.numpy()


def _roi_set(rng, kind):
    """(rois, bidx, levels, level shapes (B, H_l, W_l)) of one case."""
    if kind == "small":
        rois, bidx, levels = _rois(rng, 2, 40)
        height, width = H, W
    else:
        height, width = 832, 1344
        rois, bidx, levels = _smoke_rois(2, 48, height, width)
    shapes = [(2, height // s, width // s) for s in (4, 8, 16, 32)]
    return rois, bidx, levels, shapes


CASES = [(pooled, sr, kind) for pooled in (7, 14) for sr in (2, 0) for kind in ("small", "smoke")]


@pytest.mark.parametrize("pooled,sampling_ratio,kind", CASES)
def test_fwd_tap_plan_holds_every_live_tap(rng, pooled, sampling_ratio, kind):
    rois, bidx, levels, shapes = _roi_set(rng, kind)
    plan = fwd_tap_plan(shapes, rois, bidx, levels, SCALES, pooled, pooled, sampling_ratio)
    idx, wts, _, _, s = _bilinear_taps(shapes, torch.from_numpy(rois), torch.from_numpy(bidx),
                                       torch.from_numpy(levels), SCALES, pooled, pooled,
                                       sampling_ratio, 8)
    live = (wts[0] != 0).numpy().reshape(len(rois), pooled, pooled, s * s)
    offsets = np.cumsum([0] + [int(np.prod(sh)) for sh in shapes])
    n_live = 0
    for r, p in enumerate(plan):
        assert p is not None and (p["level"], p["image"]) == (levels[r], bidx[r])
        _, h, w = shapes[p["level"]]
        for i in idx:
            local = i[r].numpy().reshape(pooled, pooled, s * s) - offsets[p["level"]] \
                - p["image"] * h * w
            ys, xs = local // w, local % w
            for ph in range(pooled):
                rows = p["rows"][ph][0]
                assert rows == sorted(set(rows))
                m = live[r, ph]
                assert np.isin(ys[ph][m], rows).all(), (r, ph)
            for pw in range(pooled):
                cols = p["cols"][pw][0]
                assert cols == sorted(set(cols))
                m = live[r, :, pw]
                assert np.isin(xs[:, pw][m], cols).all(), (r, pw)
        n_live += int(live[r].sum())
    assert n_live > 0


@pytest.mark.parametrize("pooled,sampling_ratio,kind", CASES[::2] + CASES[1::4])
def test_fwd_tap_plan_sums_to_plain(rng, pooled, sampling_ratio, kind):
    rois, bidx, levels, shapes = _roi_set(rng, kind)
    feats = [rng.randn(*sh, 8).astype(np.float32) for sh in shapes]
    plan = fwd_tap_plan(shapes, rois, bidx, levels, SCALES, pooled, pooled, sampling_ratio)
    exp = _port(feats, rois, bidx, levels, pooled, sampling_ratio).numpy()
    got = np.zeros_like(exp)
    for r, p in enumerate(plan):
        f = feats[p["level"]][p["image"]]
        ky = np.zeros((pooled, f.shape[0]), np.float32)
        kx = np.zeros((pooled, f.shape[1]), np.float32)
        for k, axis in ((ky, "rows"), (kx, "cols")):
            for q, (taps, weights) in enumerate(p[axis]):
                k[q, taps] = weights
        got[r] = np.einsum("py,qx,yxc->pqc", ky, kx, f, optimize=True) * p["inv_count"]
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)
    assert np.abs(exp).max() > 0.5


def test_fwd_tap_plan_out_of_range_stages_nothing(rng):
    rois, bidx, levels = _rois(rng, 2, 10)
    levels[:4] = [-1, 4, 0, 1]
    bidx[:4] = [0, 1, -1, 2]
    shapes = [(2, H // s, W // s) for s in (4, 8, 16, 32)]
    plan = fwd_tap_plan(shapes, rois, bidx, levels, SCALES, 7, 7)
    assert plan[:4] == [None] * 4
    assert all(p is not None for p in plan[4:])

"""The port's C4 building blocks against the JAX package, on the CPU.

  * ``ops.roi_align.roi_align_matmul`` (the separable C4 RoIAlign, the CPU
    path of every C4 call) against JAX's ``roi_align_matmul``, and its
    gradient ``roi_align_matmul_backward`` against ``jax.vjp`` of it: atol
    1e-5 on unit-scale features, rois of every kind, including rois wider
    than 8 samples' worth per bin (the adaptive grid clipped at max_grid);
  * the C4 call site (``roi_align_c4``, ``roi_align_c4_bwd`` and the
    differentiable ``roi_align_c4_fused``) on CPU tensors: the plain
    separable form, one level at 1/16;
  * what the kernels decide per roi at C4 shapes: the forward's tap plan
    (``fwd_tap_plan``) summed separably gives ``roi_align_matmul``'s
    values, and every tile where a roi's gradient is not zero lies in the
    backward's tile lists (``roi_tile_lists``);
  * ``c4_body``, ``c5_head`` and ``res5_box_head`` in fp32 (max|d| <= 1e-4
    of max|jax|, as tests/test_torch_models.py);
  * ``rpn.generate_proposals`` with exact selections, ties included;
  * ``init_params`` blob for blob for the C4 presets and R-101-FPN, the
    R-101 body and FPN neck, and the Detectron pkl round trip of each C4
    preset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.checkpoint import caffe2_import as jc2
from detectorch_tpu.models import detector as jdet
from detectorch_tpu.models import fpn as jfpn
from detectorch_tpu.models import heads as jheads
from detectorch_tpu.models import resnet as jresnet
from detectorch_tpu.models import rpn as jrpn
from detectorch_tpu.ops.roi_align import roi_align_matmul as jax_roi_align_matmul
from detectorch_tpu_torch.checkpoint import caffe2_import as c2
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.models import detector as tdet
from detectorch_tpu_torch.models import fpn as tfpn
from detectorch_tpu_torch.models import heads as theads
from detectorch_tpu_torch.models import resnet as tresnet
from detectorch_tpu_torch.models import rpn as trpn
from detectorch_tpu_torch.ops.cuda.roi_align_kernel import (
    TILE,
    fwd_tap_plan,
    roi_align_c4,
    roi_align_c4_bwd,
    roi_tile_lists,
)
from detectorch_tpu_torch.ops.roi_align import (
    check_matmul_precision,
    roi_align_matmul,
    roi_align_matmul_backward,
    roi_geometry,
)
from detectorch_tpu_torch.ops.roi_align_fused import roi_align_c4_fused
from tests.test_torch_models import _close
from tests.torch_configs import both_configs

C4_PRESETS = ["fast_rcnn_R-50-C4_2x", "e2e_faster_rcnn_R-50-C4_2x", "e2e_mask_rcnn_R-50-C4_2x"]
SCALE, ATOL = 1.0 / 16, 1e-5
FH, FW, C = 12, 20, 16  # a 192x320 image at 1/16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _c4_rois(rng, batch, n):
    """(B, N, 4) rois over a 192x320 image: random boxes of 4-400 px, and
    rois wider than 8 samples' worth per 14x14 bin (> 1792 px), partly and
    fully outside, degenerate (x2 < x1), tiny."""
    x1 = rng.uniform(-20, 320, (batch, n))
    y1 = rng.uniform(-20, 192, (batch, n))
    bw = np.exp(rng.uniform(np.log(4), np.log(400), (batch, n)))
    bh = bw * np.exp(rng.uniform(-1.5, 1.5, (batch, n)))
    rois = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    edge = np.array([
        [-900, -40, 1300, 150],      # 2200 px wide: grid_w clipped at 8
        [10, -1000, 200, 1100],      # 2100 px tall
        [-30, -20, 120, 90],         # partly outside
        [250, 150, 200, 100],        # degenerate
        [100, 100, 100.5, 100.5],    # tiny
        [-500, -500, -400, -450],    # fully outside
    ], np.float32)
    rois[:, : len(edge)] = edge
    return rois


@pytest.fixture(scope="module")
def roi_case():
    rng = np.random.RandomState(3)
    feats = rng.randn(2, FH, FW, C).astype(np.float32)
    rois = _c4_rois(rng, 2, 14)
    return feats, rois


def test_roi_set_reaches_max_grid(roi_case):
    _, rois = roi_case
    *_, grid_h, grid_w = roi_geometry(_t(rois.reshape(-1, 4)), SCALE, 14, 14, 0, 8)
    assert int(grid_w.max()) == 8 and int(grid_h.max()) == 8
    # without the clip the widest rois would sample ceil(2200 / 16 / 14) = 10 per bin
    assert np.ceil((rois[..., 2] - rois[..., 0]).max() * SCALE / 14) > 8


@pytest.mark.parametrize("pooled,sampling_ratio", [(14, 0), (7, 0), (14, 2)])
def test_roi_align_matmul_matches_jax(roi_case, pooled, sampling_ratio):
    feats, rois = roi_case
    got = roi_align_matmul(_t(feats), _t(rois), pooled, pooled, SCALE, sampling_ratio,
                           roi_chunk=5)
    assert got.shape == (2, rois.shape[1], pooled, pooled, C) and got.dtype == torch.float32
    for b in range(2):
        exp = jax_roi_align_matmul(jnp.asarray(feats[b]), jnp.asarray(rois[b]), pooled, pooled,
                                   SCALE, sampling_ratio, precision="highest", roi_chunk=5)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(exp), rtol=0, atol=ATOL)
    # one image without a batch axis, unchunked, is the same function
    single = roi_align_matmul(_t(feats[1]), _t(rois[1]), pooled, pooled, SCALE, sampling_ratio,
                              roi_chunk=0)
    np.testing.assert_allclose(single.numpy(), got[1].numpy(), rtol=0, atol=1e-6)
    empty = roi_align_matmul(_t(feats), _t(rois[:, :0]), pooled, pooled, SCALE, sampling_ratio)
    assert empty.shape == (2, 0, pooled, pooled, C)


def test_roi_align_matmul_gradient_matches_jax_vjp(roi_case):
    feats, rois = roi_case
    rng = np.random.RandomState(4)
    g = rng.randn(2, rois.shape[1], 14, 14, C).astype(np.float32)
    got = roi_align_matmul_backward(_t(g), feats.shape, _t(rois), 14, 14, SCALE, 0,
                                    roi_chunk=5)
    assert got.shape == feats.shape and got.dtype == torch.float32
    for b in range(2):
        _, vjp = jax.vjp(lambda f: jax_roi_align_matmul(f, jnp.asarray(rois[b]), 14, 14, SCALE,
                                                        0, precision="highest", roi_chunk=5),
                         jnp.asarray(feats[b]))
        exp = np.asarray(vjp(jnp.asarray(g[b]))[0])
        assert np.abs(exp).max() > 1
        np.testing.assert_allclose(got[b].numpy(), exp, rtol=0, atol=ATOL)
    bf16 = roi_align_matmul_backward(_t(g), feats.shape, _t(rois), 14, 14, SCALE, 0,
                                     out_dtype=torch.bfloat16)
    assert torch.equal(bf16, got.to(torch.bfloat16))


def test_precision_tiers():
    for tier in ("high", "highest"):
        check_matmul_precision(tier)
    with pytest.raises(ValueError):
        check_matmul_precision("bf16")
    with pytest.raises(ValueError):
        roi_align_matmul(torch.zeros(1, 4, 4, 8), torch.zeros(1, 1, 4), 14, 14, SCALE,
                         precision="bf16")


def test_c4_call_site_on_cpu_is_the_separable_form(roi_case):
    feats, rois = roi_case
    f = _t(feats)
    out = roi_align_c4(f, _t(rois), 14, 14, SCALE, 0)
    assert torch.equal(out, roi_align_matmul(f, _t(rois), 14, 14, SCALE, 0))
    g = torch.from_numpy(np.random.RandomState(5).randn(*out.shape).astype(np.float32))
    grad = roi_align_c4_bwd(g, f.shape, _t(rois), 14, 14, SCALE, 0)
    assert torch.equal(grad, roi_align_matmul_backward(g, f.shape, _t(rois), 14, 14, SCALE, 0))
    # the differentiable form: the same forward, and the same gradient in
    # the features' dtype
    for dtype in (torch.float32, torch.bfloat16):
        leaf = f.clone().to(dtype).requires_grad_(True)
        y = roi_align_c4_fused(leaf, _t(rois), 14, 14, SCALE, 0)
        assert torch.equal(y, roi_align_matmul(leaf.detach(), _t(rois), 14, 14, SCALE, 0))
        (y * g).sum().backward()
        assert leaf.grad.dtype == dtype
        assert torch.equal(leaf.grad, roi_align_matmul_backward(
            g, f.shape, _t(rois), 14, 14, SCALE, 0, out_dtype=dtype))


def test_kernel_plans_cover_the_c4_call(roi_case):
    """At C4 shapes (one level at 1/16, sampling_ratio 0, max_grid 8): the
    forward kernel's tap plan, summed separably, gives roi_align_matmul's
    values (atol 1e-5), and the backward kernel's tile lists hold every
    tile that a roi's gradient reaches."""
    feats, rois = roi_case
    flat = rois.reshape(-1, 4)
    bidx = np.repeat(np.arange(2), rois.shape[1]).astype(np.int32)
    levels = np.zeros(len(flat), np.int32)
    shapes = [(2, FH, FW, C)]
    plan = fwd_tap_plan(shapes, flat, bidx, levels, (SCALE,), 14, 14, 0, 8)
    ref = roi_align_matmul(_t(feats), _t(rois), 14, 14, SCALE, 0).reshape(len(flat), 14, 14, C)
    for r, p in enumerate(plan):
        ky = np.zeros((14, FH), np.float32)
        kx = np.zeros((14, FW), np.float32)
        for ph, (rows, w) in enumerate(p["rows"]):
            ky[ph, rows] = w
        for pw, (cols, w) in enumerate(p["cols"]):
            kx[pw, cols] = w
        got = p["inv_count"] * np.einsum("ph,hwc,qw->pqc", ky, feats[p["image"]], kx)
        np.testing.assert_allclose(got, ref[r].numpy(), rtol=0, atol=ATOL)
    starts, lists = roi_tile_lists(shapes, flat, bidx, levels, (SCALE,), 14, 14, 0, 8)
    tiles_x = -(-FW // TILE)
    g = torch.ones(1, 1, 14, 14, C)
    for r in range(len(flat)):
        b = int(bidx[r])
        grad = roi_align_matmul_backward(g, (1, FH, FW, C), _t(flat[r][None, None]), 14, 14,
                                         SCALE, 0)[0].abs().sum(-1).numpy()
        for y, x in zip(*np.nonzero(grad)):
            t = b * (-(-FH // TILE)) * tiles_x + (y // TILE) * tiles_x + x // TILE
            assert r in lists[starts[t]:starts[t + 1]], (r, y, x)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

MASK_C4 = "e2e_mask_rcnn_R-50-C4_2x"


@pytest.fixture(scope="module")
def c4_params():
    """The C4 mask preset's JAX blobs with BN scales and biases redrawn (the
    init's zero branch2c scales would cut every residual branch out)."""
    cfg, _ = both_configs(lambda c: c.PRESETS[MASK_C4])
    p = {k: np.asarray(v) for k, v in jdet.init_params(cfg, seed=7).items()}
    rng = np.random.RandomState(11)
    for name, v in p.items():
        if name.endswith("_bn_s"):
            p[name] = rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
        elif name.endswith("_bn_b") or name.endswith("_b"):
            p[name] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return p, params_from_jax(p)


def test_c4_body_matches_jax(c4_params):
    jp, tp = c4_params
    x = (np.random.RandomState(1).randn(2, 64, 96, 3) * 30).astype(np.float32)
    got = tresnet.c4_body(tp, _t(x))
    assert got.shape == (2, 4, 6, 1024) and got.is_contiguous()
    _close(got, jresnet.c4_body(jp, jnp.asarray(x)))


def test_res5_heads_match_jax(c4_params):
    jp, tp = c4_params
    feats = np.random.RandomState(2).randn(3, 14, 14, 1024).astype(np.float32)
    c5 = tresnet.c5_head(tp, _t(feats))
    assert c5.shape == (3, 7, 7, 2048)
    _close(c5, jresnet.c5_head(jp, jnp.asarray(feats)))
    box = theads.res5_box_head(tp, _t(feats))
    assert box.shape == (3, 2048) and box.dtype == torch.float32
    _close(box, jheads.res5_box_head(jp, jnp.asarray(feats)))
    # bf16 operands: the mean is taken in bf16, as JAX's
    got = theads.res5_box_head(tp, _t(feats).to(torch.bfloat16))
    exp = jheads.res5_box_head(jp, jnp.asarray(feats).astype(jnp.bfloat16))
    assert got.dtype == torch.float32
    _close(got, exp, rel=3e-2)


def test_generate_proposals_selects_exactly():
    """Quantised objectness (ties within and across anchors) and deltas:
    the same boxes, scores and validity as JAX's single-image function."""
    rng = np.random.RandomState(6)
    fh, fw, a = 6, 9, 15
    probs = rng.choice(np.linspace(0.05, 0.95, 12), (2, fh, fw, a)).astype(np.float32)
    deltas = (rng.randn(2, fh, fw, 4 * a) * 0.3).astype(np.float32)
    im_h = np.array([96.0, 80.0], np.float32)
    im_w = np.array([144.0, 128.0], np.float32)
    im_scale = np.array([1.5, 0.8], np.float32)
    kw = dict(feat_stride=16.0, anchor_sizes=(32, 64, 128, 256, 512),
              anchor_aspect_ratios=(0.5, 1.0, 2.0), pre_nms_top_n=300, post_nms_top_n=40,
              nms_thresh=0.7, min_size=8.0)
    got = trpn.generate_proposals(_t(probs), _t(deltas), _t(im_h), _t(im_w), _t(im_scale), **kw)
    assert got.boxes.shape == (2, 40, 4)
    for b in range(2):
        exp = jrpn.generate_proposals(jnp.asarray(probs[b]), jnp.asarray(deltas[b]),
                                      jnp.float32(im_h[b]), jnp.float32(im_w[b]),
                                      jnp.float32(im_scale[b]), **kw)
        np.testing.assert_array_equal(got.valid[b].numpy(), np.asarray(exp.valid))
        np.testing.assert_array_equal(got.scores[b].numpy(), np.asarray(exp.scores))
        v = np.asarray(exp.valid)
        assert v.sum() > 10
        np.testing.assert_allclose(got.boxes[b].numpy()[v], np.asarray(exp.boxes)[v],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("preset", C4_PRESETS + ["e2e_mask_rcnn_R-101-FPN_2x"])
def test_init_params_blob_for_blob(preset):
    cfg, pcfg = both_configs(lambda c: c.PRESETS[preset])
    jp = jdet.init_params(cfg, seed=3)
    tp = tdet.init_params(pcfg, seed=3)
    assert set(jp) == set(tp)
    for k in jp:
        assert np.array_equal(np.asarray(jp[k]), tp[k]), k
    if not cfg.use_fpn:
        assert ("conv_rpn_w" in tp) == cfg.use_rpn
        if cfg.use_rpn:
            assert tp["conv_rpn_w"].shape == (3, 3, 1024, 1024)
            assert tp["rpn_bbox_pred_w"].shape == (1, 1, 1024, 60)
        assert tp["cls_score_w"].shape == (81, 2048)
        assert ("conv5_mask_w" in tp) == cfg.use_mask
        if cfg.use_mask:
            assert tp["conv5_mask_w"].shape == (2048, 256, 2, 2)


def test_r101_body_and_neck_match_jax():
    cfg, _ = both_configs(lambda c: c.PRESETS["e2e_mask_rcnn_R-101-FPN_2x"])
    assert cfg.arch == "resnet101"
    jp = {k: np.asarray(v) for k, v in jdet.init_params(cfg, seed=5).items()}
    rng = np.random.RandomState(13)
    for name, v in jp.items():
        if name.endswith("_bn_s"):
            jp[name] = rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
        elif name.endswith("_bn_b") or name.endswith("_b"):
            jp[name] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    tp = params_from_jax(jp)
    x = (rng.randn(1, 64, 96, 3) * 30).astype(np.float32)
    got = tresnet.multilevel_body(tp, _t(x), "resnet101")
    exp = jresnet.multilevel_body(jp, jnp.asarray(x), "resnet101")
    for k in ("c2", "c3", "c4", "c5"):
        _close(got[k], exp[k])
    pyr = tfpn.fpn_neck(tp, got, "resnet101")
    jpyr = jfpn.fpn_neck(jp, exp, "resnet101")
    assert len(pyr) == 4
    for a, b in zip(pyr, jpyr):
        _close(a, b)


@pytest.mark.parametrize("preset", C4_PRESETS)
def test_c4_pkl_round_trip(preset, tmp_path):
    """save_caffe2_pkl -> load_caffe2_pkl -> import_params gives the params
    back bit for bit; the port writes what the JAX package writes (res5 in
    the head, conv_rpn/rpn_* without a suffix, conv5_mask_w (2048, 256, 2,
    2)); and the JAX importer reads the port's file to the same tensors."""
    cfg, pcfg = both_configs(lambda c: c.PRESETS[preset])
    jp = {k: np.asarray(v) for k, v in jdet.init_params(cfg, seed=2).items()}
    params = params_from_jax(jp)
    path = str(tmp_path / "m.pkl")
    c2.save_caffe2_pkl(params, pcfg, path)
    blobs = c2.load_caffe2_pkl(path)
    jax_blobs = jc2.export_to_caffe2_layout(jp, cfg)
    assert set(blobs) == set(jax_blobs)
    for k in jax_blobs:
        assert np.array_equal(blobs[k], jax_blobs[k]), k
    assert blobs["res5_2_branch2c_w"].shape == (2048, 512, 1, 1)
    assert ("conv_rpn_w" in blobs) == cfg.use_rpn
    if cfg.use_mask:
        assert blobs["conv5_mask_w"].shape == (2048, 256, 2, 2)
    back = c2.import_params(blobs, pcfg)
    assert set(back) == set(params)
    for k in params:
        assert torch.equal(back[k], params[k]), k
    jback = params_from_jax(jc2.import_params(jc2.load_caffe2_pkl(path), cfg))
    for k in params:
        assert torch.equal(jback[k], params[k]), k

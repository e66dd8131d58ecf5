"""The port's keypoint pieces against the JAX package, one function at a time:
the head's init, deconv4x4s2, bilinear_upsample2x, keypoint_head, the
heatmap decode, the keypoint loss, the device-side heatmap labels, the COCO
keypoint results, and the keypoint blobs through both checkpoint bridges.

Small sizes (KeypointConfig(num_convs=2, conv_dim=32) widths), one torch
thread. Tolerances: heatmap labels, valid flags, argmax indices and init
blobs exact; fp32 head outputs atol 1e-5 (outputs ~3; conv sums in another
order); bf16 head outputs rtol 2e-2 of the output's scale (bf16 rounding of
activations, placed differently by oneDNN and XLA); decoded x/y and logits
within 1e-5 of their scale (fp32, the same heatmaps); probabilities rtol
1e-5 (a sum over 3136 bins, rounded by order); losses rtol 1e-5.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.checkpoint import caffe2_import as jc2
from detectorch_tpu.eval import engine as jengine
from detectorch_tpu.models import detector as jdet
from detectorch_tpu.models import heads as jheads
from detectorch_tpu.ops import keypoints as jkp
from detectorch_tpu.train import e2e as je2e
from detectorch_tpu.train import losses as jlosses
from detectorch_tpu_torch.checkpoint import caffe2_import as tc2
from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_jax
from detectorch_tpu_torch.eval import engine as tengine
from detectorch_tpu_torch.models import detector as tdet
from detectorch_tpu_torch.models import heads as theads
from detectorch_tpu_torch.ops import keypoints as tkp
from detectorch_tpu_torch.train import e2e as te2e
from detectorch_tpu_torch.train import losses as tlosses
from tests.torch_configs import both_configs

P, CONVS, DIM = 17, 2, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _kp_cfgs(preset="e2e_keypoint_rcnn_R-50-FPN_1x"):
    return both_configs(lambda c: c.PRESETS[preset].replace(
        keypoint=c.KeypointConfig(num_convs=CONVS, conv_dim=DIM)))


@pytest.mark.parametrize("in_ch", [256, 1024], ids=["fpn", "c4"])
def test_init_keypoint_head_params_match_jax(in_ch):
    got = theads.init_keypoint_head_params(P, CONVS, DIM, in_ch, seed=6)
    exp = jheads.init_keypoint_head_params(P, CONVS, DIM, in_ch, seed=6)
    assert sorted(got) == sorted(exp) == sorted(
        [f"conv_fcn{i}_{s}" for i in (1, 2) for s in "wb"] + ["kps_score_lowres_b",
                                                              "kps_score_lowres_w"])
    for k in exp:
        assert got[k].dtype == exp[k].dtype and np.array_equal(got[k], exp[k]), k


@pytest.mark.parametrize("preset", ["e2e_keypoint_rcnn_R-50-FPN_1x", "e2e_faster_rcnn_R-50-C4_2x"],
                         ids=["fpn", "c4"])
def test_init_params_carry_the_keypoint_head(preset):
    """init_params of a keypoint config: the keypoint blobs, in_ch 256 on
    FPN and 1024 on C4, blob for blob equal to JAX's (seed + 5)."""
    cfg, pcfg = _kp_cfgs(preset)
    got, exp = tdet.init_params(pcfg, seed=3), jdet.init_params(cfg, seed=3)
    assert sorted(got) == sorted(exp)
    for k in (k for k in exp if k.startswith(("conv_fcn", "kps_score"))):
        assert np.array_equal(got[k], np.asarray(exp[k])), k
    assert got["conv_fcn1_w"].shape == (3, 3, 256 if pcfg.use_fpn else 1024, DIM)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deconv_upsample_and_head_match_jax(dtype):
    rng = np.random.RandomState(0)
    params = jheads.init_keypoint_head_params(P, CONVS, DIM, 16, seed=6)
    params["kps_score_lowres_b"] = rng.randn(P).astype(np.float32)
    for i in (1, 2):
        params[f"conv_fcn{i}_b"] = (rng.randn(DIM) * 0.1).astype(np.float32)
    tp = params_from_jax(params)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    x = rng.randn(3, 14, 14, 16).astype(np.float32)
    low = rng.randn(3, 14, 14, DIM).astype(np.float32)

    def close(got, exp, what):
        exp = np.asarray(exp, np.float32)
        got = got.float().numpy()
        assert got.shape == exp.shape, what
        tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(exp).max()
        np.testing.assert_allclose(got, exp, rtol=0, atol=tol, err_msg=what)

    deconv = theads.deconv4x4s2(tp, _t(low).to(td), "kps_score_lowres")
    assert deconv.dtype == td and deconv.shape == (3, 28, 28, P)
    close(deconv, jheads.deconv4x4s2(params, jnp.asarray(low, jd), "kps_score_lowres"),
          "deconv4x4s2")
    up = theads.bilinear_upsample2x(_t(low[..., :P]))
    close(up, jheads.bilinear_upsample2x(jnp.asarray(low[..., :P])), "bilinear_upsample2x")
    heat = theads.keypoint_head(tp, _t(x).to(td), CONVS)
    assert heat.dtype == torch.float32 and heat.shape == (3, 56, 56, P)
    close(heat, jheads.keypoint_head(params, jnp.asarray(x, jd), CONVS), "keypoint_head")


def test_heatmaps_to_keypoints_matches_jax():
    """Random heatmaps, plus ties: a flat heatmap (argmax 0), two equal
    maxima (the first in (H*W) order wins) and one maximum repeated down a
    column; boxes of every width, narrower than 1 px included."""
    rng = np.random.RandomState(1)
    k = 12
    heat = (rng.randn(k, 56, 56, P) * 3).astype(np.float32)
    heat[0, :, :, 0] = 0.5                      # flat
    heat[1, :, :, 1] = -2.0
    heat[1, 10, 40, 1] = heat[1, 30, 5, 1] = 7.0  # a tie: (10, 40) comes first
    heat[2, :, :, 2] = -2.0
    heat[2, 20:25, 33, 2] = 4.0                 # a column of equal maxima
    x1, y1 = rng.uniform(-20, 300, (2, k))
    bw = np.exp(rng.uniform(np.log(0.3), np.log(400), k))
    bh = np.exp(rng.uniform(np.log(0.3), np.log(400), k))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)
    exp = np.asarray(jkp.heatmaps_to_keypoints(jnp.asarray(heat), jnp.asarray(boxes)))
    got = tkp.heatmaps_to_keypoints(_t(heat), _t(boxes)).numpy()
    assert got.shape == exp.shape == (k, P, 4)
    flat = heat.reshape(k, 56 * 56, P)
    idx = np.argmax(flat, axis=1)
    assert idx[0, 0] == 0 and idx[1, 1] == 10 * 56 + 40 and idx[2, 2] == 20 * 56 + 33
    # the argmax bin is exact: x, y equal up to the fp32 box arithmetic
    np.testing.assert_allclose(got[..., :2], exp[..., :2], rtol=0, atol=1e-5 * 700)
    np.testing.assert_array_equal(got[..., 2], exp[..., 2])  # logits: the max itself
    np.testing.assert_allclose(got[..., 3], exp[..., 3], rtol=1e-5)
    # batched leading axes give the same rows
    batched = tkp.heatmaps_to_keypoints(_t(heat).reshape(3, 4, 56, 56, P),
                                        _t(boxes).reshape(3, 4, 4))
    assert torch.equal(batched.reshape(k, P, 4), _t(got))


def test_keypoint_loss_matches_jax():
    rng = np.random.RandomState(2)
    b, r, s = 2, 6, 8
    logits = (rng.randn(b, r, s, s, P) * 2).astype(np.float32)
    labels = rng.randint(0, s * s, (b, r, P)).astype(np.int32)
    valid = rng.rand(b, r, P) > 0.4
    valid[1] = False  # an image without a valid keypoint: loss 0
    got = tlosses.keypoint_loss(_t(logits), _t(labels), _t(valid))
    assert got.shape == (b,)
    for i in range(b):
        exp = float(jlosses.keypoint_loss(logits[i], labels[i], valid[i]))
        np.testing.assert_allclose(float(got[i]), exp, rtol=1e-5)
    assert float(got[1]) == 0.0
    bf = tlosses.keypoint_loss(_t(logits).bfloat16(), _t(labels), _t(valid))
    assert bf.dtype == torch.float32  # the log-softmax runs in fp32


def _edge_case():
    """Rois with integer corners and every width from 1 to 200 px, and
    keypoints placed exactly on the fp32 bin edges x1 + k * w / 56 (k = 0
    .. 56: on the left, inside and on the right/bottom roi edges), plus
    keypoints just outside, unlabelled ones (v = 0), and degenerate rois.
    Corners from 1 px on: one float below 0 is a denormal, which XLA:CPU
    flushes to zero and torch keeps, and no image coordinate is one."""
    rng = np.random.RandomState(0)
    r = 400
    x1 = np.round(rng.uniform(1, 100, r)).astype(np.float32)
    y1 = np.round(rng.uniform(1, 100, r)).astype(np.float32)
    w = rng.uniform(1, 200, r).astype(np.float32)
    h = rng.uniform(1, 200, r).astype(np.float32)
    w[:20] = np.arange(1, 21)  # integer widths
    rois = np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)
    k = rng.randint(0, 57, (r, P)).astype(np.float32)
    kx = rois[:, :1] + k * (rois[:, 2:3] - rois[:, :1]) / np.float32(56)
    ky = rois[:, 1:2] + k[:, ::-1] * (rois[:, 3:4] - rois[:, 1:2]) / np.float32(56)
    kx[:, 0] = rois[:, 2]                        # on the right edge: the last bin
    ky[:, 1] = rois[:, 3]                        # on the bottom edge
    kx[:, 2] = np.nextafter(rois[:, 2], np.float32(1e9))  # just outside: invalid
    ky[:, 3] = np.nextafter(rois[:, 1], np.float32(-1e9))
    v = rng.randint(0, 3, (r, P)).astype(np.float32)
    v[:, :4] = 2
    kps = np.stack([kx, ky, v], -1).astype(np.float32)
    rois[-4:] = [[5, 5, 5, 9], [5, 5, 3, 9], [0, 0, 0, 0], [7, 7, 7.5, 7.25]]  # degenerate
    return kps, rois


def test_keypoint_labels_device_match_jax_exactly():
    kps, rois = _edge_case()
    jl, jv = map(np.asarray, je2e.keypoint_labels_device(jnp.asarray(kps), jnp.asarray(rois), 56))
    tl, tv = te2e.keypoint_labels_device(_t(kps), _t(rois), 56)
    assert tl.dtype == torch.int32 and tv.dtype == torch.bool
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tv.numpy(), jv)
    # on the right/bottom edges: the last bin (the degenerate rois aside)
    assert jv[:-4, :2].all() and not jv[:, 2:4].any() and 0.3 < jv.mean() < 0.9
    assert (jl[:-4, 0] % 56 == 55).all() and (jl[:-4, 1] // 56 == 55).all()
    # batched leading axes give the same rows
    bl, bv = te2e.keypoint_labels_device(_t(kps).reshape(4, 100, P, 3),
                                         _t(rois).reshape(4, 100, 4), 56)
    assert torch.equal(bl.reshape(-1, P), tl) and torch.equal(bv.reshape(-1, P), tv)
    # the set reaches the trap: a Python number over a tensor (torch's
    # reciprocal multiply) moves keypoints on bin edges into another bin
    t_rois, t_kps = _t(rois), _t(kps)
    naive = torch.floor((t_kps[..., 0] - t_rois[:, 0:1])
                        * (56.0 / torch.clamp_min(t_rois[:, 2:3] - t_rois[:, 0:1], 1e-6)))
    exact = np.floor((kps[..., 0] - rois[:, 0:1])
                     * np.asarray(56.0 / jnp.maximum(jnp.asarray(rois[:, 2:3] - rois[:, 0:1]),
                                                     1e-6)))
    assert (naive.numpy() != exact).any()


@pytest.mark.parametrize("confidence", ["bbox", "logit", "prob"])
def test_detections_to_coco_keypoints_match_jax(confidence):
    rng = np.random.RandomState(3)
    kps = rng.randn(5, P, 4).astype(np.float32) * 30
    scores = rng.rand(5).astype(np.float32)
    classes = np.ones(5, np.int64)
    c2j = {0: 0, 1: 1}
    got = tengine.detections_to_coco_keypoints(kps, scores, classes, 7, c2j, confidence)
    exp = jengine.detections_to_coco_keypoints(kps, scores, classes, 7, c2j, confidence)
    assert got == exp and len(got) == 5 and len(got[0]["keypoints"]) == 3 * P


def test_detections_to_coco_keypoints_refuses_an_unknown_mode():
    with pytest.raises(ValueError):
        tengine.detections_to_coco_keypoints(np.zeros((1, P, 4)), [1.0], [1], 1, {1: 1}, "max")


def test_keypoint_blobs_carry_across_both_bridges(tmp_path):
    """conv_fcn{1..8}_{w,b} and kps_score_lowres_{w,b} of the full keypoint
    head (JAX's init_keypoint_head_params): from JAX's layout (HWIO convs;
    the deconv's (C_in, C_out, 4, 4) as it is) and back, and from a
    Detectron-layout pkl of those blobs through both importers (the rest of
    the preset's blobs from each side's random skeleton) to the same
    values."""
    cfg, pcfg = both_configs(lambda c: c.PRESETS["e2e_keypoint_rcnn_R-50-FPN_1x"])
    jp = jheads.init_keypoint_head_params(17, 8, 512, 256, seed=5)
    names = [f"conv_fcn{i}_{s}" for i in range(1, 9) for s in "wb"] + [
        "kps_score_lowres_w", "kps_score_lowres_b"]
    assert sorted(jp) == sorted(names)
    tp = params_from_jax(jp)
    assert tuple(tp["conv_fcn1_w"].shape) == (512, 256, 3, 3)
    assert tuple(tp["conv_fcn8_w"].shape) == (512, 512, 3, 3)
    assert tuple(tp["kps_score_lowres_w"].shape) == (512, 17, 4, 4)
    np.testing.assert_array_equal(tp["kps_score_lowres_w"].numpy(), jp["kps_score_lowres_w"])
    np.testing.assert_array_equal(tp["conv_fcn3_w"].numpy(),
                                  jp["conv_fcn3_w"].transpose(3, 2, 0, 1))
    back = params_to_jax(tp)
    for k in names:
        np.testing.assert_array_equal(back[k], jp[k], err_msg=k)
    # a Detectron pkl (caffe2 layout) of the keypoint blobs, read by both
    pkl = str(tmp_path / "kp.pkl")
    tc2.save_caffe2_pkl(tp, pcfg, pkl)
    with open(pkl, "rb") as f:
        blobs = pickle.load(f)["blobs"]
    np.testing.assert_array_equal(blobs["conv_fcn2_w"], tp["conv_fcn2_w"].numpy())  # OIHW
    got = tc2.import_params(tc2.load_caffe2_pkl(pkl), pcfg, strict=False)
    exp = jc2.import_params(jc2.load_caffe2_pkl(pkl), cfg, strict=False)
    for k in names:
        assert torch.equal(got[k], tp[k]), k
        np.testing.assert_array_equal(np.asarray(exp[k]), jp[k], err_msg=k)

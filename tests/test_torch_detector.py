"""The port's whole Mask R-CNN R-50-FPN inference path against the JAX package.

Setting of tests/test_golden.py: fp32 compute, RPN 300 -> 64 proposals,
16 detections (+ 8 tie slots) at score_thresh 0, init_params(seed=123),
96x128 images; here a batch of 2 images through the port's batched
program, against JAX's make_inference_fn run on each image. JAX runs its
exact-gather RoIAlign (use_pallas_roi_align=False): the port's RoIAlign is
exact for every roi, and the Pallas kernel is exact only where its slab
fits (tests/test_torch_roi_align.py holds the port to both).

Random weights leave near-ties in the final top-K (test_golden.py:37-40),
so the end-to-end comparison checks what is deterministic, and each stage
is then fed the JAX side's input so that its selection must be exactly
equal. Tolerances (fp32): rois atol 2e-3 px (backbone drift of ~1e-6
through exp() of the RPN deltas on boxes of ~100 px); softmax scores,
deltas and mask probabilities atol 1e-5 (they sit at ~1e-7 of each other).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.eval import postprocess as jpost
from detectorch_tpu.models import detector as jdet
from detectorch_tpu.models import fpn as jfpn
from detectorch_tpu.models import resnet as jresnet
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.eval import postprocess as tpost
from detectorch_tpu_torch.config import PRESETS
from detectorch_tpu_torch.models import detector as tdet
from tests.torch_configs import both_configs

# JAX's configuration and the port's (P...), each from its own package
CFG, PCFG = both_configs(lambda c: c.PRESETS["e2e_mask_rcnn_R-50-FPN_2x"].replace(
    compute_dtype="float32",
    rpn=c.RPNConfig(pre_nms_top_n=300, post_nms_top_n=64),
    use_pallas_roi_align=False,
))
TCFG, PTCFG = both_configs(lambda c: c.TestConfig(detections_per_img=16, score_thresh=0.0))
ROI_ATOL, ATOL = 2e-3, 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def run():
    """Inputs, both packages' params, the port's batched outputs and JAX's
    per-image outputs."""
    jp = jdet.init_params(CFG, seed=123)
    tp = params_from_jax(tdet.init_params(PCFG, seed=123))
    rng = np.random.RandomState(5)
    images = (rng.randn(2, 96, 128, 3) * 12).astype(np.float32)
    scale = np.array([1.2, 1.1], np.float32)
    orig_h = np.array([80.0, 70.0], np.float32)
    orig_w = np.array([106.0, 110.0], np.float32)
    inputs = (images, scale, orig_h, orig_w)
    out = tdet.make_inference_fn(PCFG, PTCFG)(tp, *map(_t, inputs))
    jfwd = jax.jit(jdet.make_inference_fn(CFG, TCFG))
    jout = [jfwd(jp, images[b], jnp.float32(scale[b]), jnp.float32(orig_h[b]),
                 jnp.float32(orig_w[b])) for b in range(2)]
    return inputs, jp, tp, out, [jax.tree.map(np.asarray, o) for o in jout]


def test_whole_path_matches_jax(run):
    _, _, _, out, jout = run
    assert out.detections.boxes.shape == (2, 24, 4) and out.masks.shape == (2, 24, 28, 28)
    assert out.roi_align_exact.all() and out.all_exact.all()
    for b, jo in enumerate(jout):
        np.testing.assert_array_equal(out.roi_valid[b].numpy(), jo.roi_valid)
        assert jo.roi_valid.sum() > 16
        np.testing.assert_allclose(out.rois[b].numpy(), jo.rois, rtol=0, atol=ROI_ATOL)
        np.testing.assert_allclose(out.cls_scores[b].numpy(), jo.cls_scores, rtol=0, atol=ATOL)
        np.testing.assert_allclose(out.bbox_deltas[b].numpy(), jo.bbox_deltas, rtol=0, atol=ATOL)
        d, jd = out.detections, jo.detections
        assert int(d.valid[b].sum()) == int(jd.valid.sum()) >= 16
        np.testing.assert_allclose(np.sort(d.scores[b][d.valid[b]].numpy()),
                                   np.sort(jd.scores[jd.valid]), rtol=0, atol=ATOL)
        # masks of the detections both sides selected (same class, same box)
        matched = 0
        for i in np.flatnonzero(d.valid[b].numpy()):
            same = (jd.classes == int(d.classes[b, i])) & jd.valid & (
                np.abs(jd.boxes - d.boxes[b, i].numpy()).max(axis=1) < ROI_ATOL)
            if same.any():
                j = int(np.flatnonzero(same)[0])
                np.testing.assert_allclose(out.masks[b, i].numpy(), jo.masks[j],
                                           rtol=0, atol=ATOL)
                matched += 1
        assert matched >= int(d.valid[b].sum()) // 2


def test_proposals_from_jax_pyramid_select_exactly(run):
    (images, scale, orig_h, orig_w), jp, tp, _, jout = run
    im_h, im_w = tdet.blob_bounds(PCFG, images.shape[1:3], _t(scale), _t(orig_h), _t(orig_w))
    pyramids = [jfpn.fpn_neck(jp, jresnet.multilevel_body(jp, jnp.asarray(images[b:b + 1])))
                for b in range(2)]
    pyramid = [_t(np.concatenate([np.asarray(p[lvl]) for p in pyramids])) for lvl in range(4)]
    props = tdet._fpn_level_proposals(tp, PCFG, pyramid, im_h, im_w, _t(scale))
    for b, jo in enumerate(jout):
        np.testing.assert_array_equal(props.valid[b].numpy(), jo.roi_valid)
        np.testing.assert_allclose(props.boxes[b].numpy(), jo.rois, rtol=0, atol=1e-4)


def test_blob_bounds_match_jax():
    scale = np.array([1.2, 1.66, 0.5], np.float32)
    orig_h = np.array([80.0, 500.0, 33.0], np.float32)
    orig_w = np.array([106.0, 800.0, 47.0], np.float32)
    im_h, im_w = tdet.blob_bounds(PCFG, (832, 1344), _t(scale), _t(orig_h), _t(orig_w))
    # JAX's make_inference_fn computes them inline (detector.py:176-181)
    exp_h = np.minimum(np.ceil(np.minimum(np.round(orig_h * scale), 832) / 32) * 32, 832)
    exp_w = np.minimum(np.ceil(np.minimum(np.round(orig_w * scale), 1344) / 32) * 32, 1344)
    np.testing.assert_array_equal(im_h.numpy(), exp_h)
    np.testing.assert_array_equal(im_w.numpy(), exp_w)


def test_box_branch_on_jax_rois(run):
    (images, scale, orig_h, orig_w), _, tp, out, jout = run
    with torch.inference_mode():
        feats = tdet.resnet_mod.multilevel_body(tp, _t(images))
        pyramid = tdet.fpn_mod.fpn_neck(tp, feats)
        cls, deltas, _ = tdet.box_branch(
            tp, PCFG, PTCFG, pyramid, _t(np.stack([j.rois for j in jout])),
            _t(np.stack([j.roi_valid for j in jout])), _t(scale), _t(orig_h), _t(orig_w))
    for b, jo in enumerate(jout):
        np.testing.assert_allclose(cls[b].numpy(), jo.cls_scores, rtol=0, atol=ATOL)
        np.testing.assert_allclose(deltas[b].numpy(), jo.bbox_deltas, rtol=0, atol=ATOL)


def test_postprocess_on_jax_scores_selects_exactly(run):
    (_, scale, orig_h, orig_w), _, _, _, jout = run
    d = tpost.postprocess_detections(
        *(_t(np.stack([getattr(j, f) for j in jout]))
          for f in ("cls_scores", "bbox_deltas", "rois", "roi_valid")),
        _t(scale), _t(orig_h), _t(orig_w), PTCFG, PCFG.num_classes)
    for b, jo in enumerate(jout):
        jd = jo.detections
        np.testing.assert_array_equal(d.valid[b].numpy(), jd.valid)
        np.testing.assert_array_equal(d.classes[b].numpy(), jd.classes)
        np.testing.assert_allclose(d.scores[b].numpy(), jd.scores, rtol=0, atol=1e-7)
        np.testing.assert_allclose(d.boxes[b].numpy(), jd.boxes, rtol=0, atol=1e-4)


def test_mask_branch_on_jax_detections(run):
    (images, scale, _, _), _, tp, _, jout = run
    with torch.inference_mode():
        feats = tdet.resnet_mod.multilevel_body(tp, _t(images))
        pyramid = tdet.fpn_mod.fpn_neck(tp, feats)
        masks = tdet.mask_branch(
            tp, PCFG, pyramid, _t(np.stack([j.detections.boxes for j in jout])),
            _t(np.stack([j.detections.classes for j in jout])).long(), _t(scale))
    for b, jo in enumerate(jout):
        np.testing.assert_allclose(masks[b].numpy(), jo.masks, rtol=0, atol=ATOL)


@pytest.mark.parametrize("prefilter", [0, 20])
def test_postprocess_ties_and_prefilter_match_jax(rng, prefilter):
    # quantised scores tie at the global cap and within classes; with the
    # prefilter, some classes exceed it and nms_exact goes False
    b, n, c = 2, 64, 6
    tcfg, ptcfg = both_configs(lambda c: c.TestConfig(
        detections_per_img=10, detections_tie_slack=8, score_thresh=0.05,
        nms_topk_prefilter=prefilter))
    x1 = rng.uniform(0, 300, (b, n))
    y1 = rng.uniform(0, 200, (b, n))
    rois = np.stack([x1, y1, x1 + rng.uniform(5, 80, (b, n)),
                     y1 + rng.uniform(5, 80, (b, n))], -1).astype(np.float32)
    scores = rng.choice([0.0, 0.04, 0.2, 0.5, 0.5, 0.8], size=(b, n, c)).astype(np.float32)
    scores[1, :, 2] = 0.0  # a class with no candidate
    deltas = (rng.randn(b, n, 4 * c) * 0.5).astype(np.float32)
    valid = rng.rand(b, n) > 0.1
    scale = np.array([1.5, 0.9], np.float32)
    oh = np.array([200.0, 250.0], np.float32)
    ow = np.array([260.0, 330.0], np.float32)
    d = tpost.postprocess_detections(_t(scores), _t(deltas), _t(rois), _t(valid), _t(scale),
                                     _t(oh), _t(ow), ptcfg, c)
    for i in range(b):
        jd = jpost.postprocess_detections(
            jnp.asarray(scores[i]), jnp.asarray(deltas[i]), jnp.asarray(rois[i]),
            jnp.asarray(valid[i]), jnp.float32(scale[i]), jnp.float32(oh[i]),
            jnp.float32(ow[i]), tcfg, c)
        np.testing.assert_array_equal(d.valid[i].numpy(), np.asarray(jd.valid))
        np.testing.assert_array_equal(d.classes[i].numpy(), np.asarray(jd.classes))
        np.testing.assert_array_equal(d.scores[i].numpy(), np.asarray(jd.scores))
        np.testing.assert_allclose(d.boxes[i].numpy(), np.asarray(jd.boxes), rtol=0, atol=1e-4)
        assert bool(d.nms_exact[i]) == bool(jd.nms_exact)
    assert int(d.valid.sum(dim=1).max()) > 10  # ties at the cap survived


def test_mask_fn_on_jax_detections(run):
    """make_mask_fn recomputes the backbone and runs the mask branch on given
    boxes: on JAX's final detections it equals JAX's make_mask_fn."""
    (images, scale, orig_h, orig_w), jp, tp, _, jout = run
    masks = tdet.make_mask_fn(PCFG)(
        tp, *map(_t, (images, scale, orig_h, orig_w)),
        _t(np.stack([j.detections.boxes for j in jout])),
        _t(np.stack([j.detections.classes for j in jout])))
    assert masks.shape == (2, 24, 28, 28)
    jmask = jax.jit(jdet.make_mask_fn(CFG))
    for b, jo in enumerate(jout):
        jm, _ = jmask(jp, images[b], jnp.float32(scale[b]), jnp.float32(orig_h[b]),
                      jnp.float32(orig_w[b]), jo.detections.boxes, jo.detections.classes)
        np.testing.assert_allclose(masks[b].numpy(), np.asarray(jm), rtol=0, atol=ATOL)
    with pytest.raises(ValueError):
        tdet.make_mask_fn(PRESETS["fast_rcnn_R-50-FPN_2x"])


def test_fast_rcnn_fpn_matches_jax(rng):
    """Fast R-CNN FPN inference from given proposals: the same rois, and the
    box branch's scores and deltas within ATOL of JAX's per-image program."""
    cfg, pcfg = both_configs(lambda c: c.PRESETS["fast_rcnn_R-50-FPN_2x"].replace(
        compute_dtype="float32", use_pallas_roi_align=False))
    jp = jdet.init_params(cfg, seed=9)
    tp = params_from_jax(tdet.init_params(pcfg, seed=9))
    images = (rng.randn(2, 96, 128, 3) * 12).astype(np.float32)
    scale = np.array([1.2, 1.1], np.float32)
    orig_h = np.array([80.0, 70.0], np.float32)
    orig_w = np.array([106.0, 110.0], np.float32)
    x1 = rng.uniform(0, 90, (2, 32))
    y1 = rng.uniform(0, 60, (2, 32))
    props = np.stack([x1, y1, x1 + rng.uniform(4, 60, (2, 32)),
                      y1 + rng.uniform(4, 40, (2, 32))], -1).astype(np.float32)
    valid = np.ones((2, 32), bool)
    valid[1, 20:] = False
    out = tdet.make_inference_fn(pcfg, PTCFG)(tp, *map(_t, (images, scale, orig_h, orig_w)),
                                              _t(props), _t(valid))
    jfwd = jax.jit(jdet.make_inference_fn(cfg, TCFG))
    for b in range(2):
        jo = jfwd(jp, images[b], jnp.float32(scale[b]), jnp.float32(orig_h[b]),
                  jnp.float32(orig_w[b]), props[b], valid[b])
        assert torch.equal(out.rois[b], _t(props[b])) and out.masks is None
        np.testing.assert_array_equal(out.roi_valid[b].numpy(), np.asarray(jo.roi_valid))
        np.testing.assert_allclose(out.cls_scores[b].numpy(), np.asarray(jo.cls_scores),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(out.bbox_deltas[b].numpy(), np.asarray(jo.bbox_deltas),
                                   rtol=0, atol=ATOL)
        d, jd = out.detections, jo.detections
        assert int(d.valid[b].sum()) == int(np.asarray(jd.valid).sum()) >= 16
        np.testing.assert_allclose(np.sort(d.scores[b][d.valid[b]].numpy()),
                                   np.sort(np.asarray(jd.scores)[np.asarray(jd.valid)]),
                                   rtol=0, atol=ATOL)
    # without a validity mask every proposal is valid
    all_valid = tdet.make_inference_fn(pcfg, PTCFG)(
        tp, *map(_t, (images, scale, orig_h, orig_w)), _t(props))
    assert all_valid.roi_valid.all()
    with pytest.raises(ValueError):
        tdet.make_inference_fn(pcfg, PTCFG)(tp, *map(_t, (images, scale, orig_h, orig_w)))


@pytest.mark.parametrize("preset", ["e2e_mask_rcnn_R-50-C4_2x", "fast_rcnn_R-50-C4_2x",
                                    "e2e_keypoint_rcnn_R-50-FPN_1x"])
def test_unported_branches_raise(preset):
    with pytest.raises(NotImplementedError):
        tdet.make_inference_fn(PRESETS[preset], PTCFG)

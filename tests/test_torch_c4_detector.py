"""The port's C4 inference path against the JAX package: Fast, Faster and
Mask R-CNN R-50-C4 through ``make_inference_fn`` and ``make_mask_fn``.

fp32 compute, RPN 200 -> 16 proposals, 8 detections (+ 8 tie slots) at
score_thresh 0, init_params(seed=123), a batch of two 64x96 images through
the port's batched program, against JAX's per-image program. The images
are noise of standard deviation 4, not tests/test_torch_detector.py's 12:
the random-weight C4 trunk has no FPN neck between its res4 and the RPN,
and at 12 its c4 map reaches ~165 and the RPN's deltas ~16, so fp32
summation-order drift through exp() of the deltas moves rois by up to
7.2e-3 px (cls scores by 1.3e-5); at 4 they stay within 7.2e-4 px and
4.4e-6, inside the tolerances below.

As there, the whole path is compared where it is deterministic, and each
stage is then fed the JAX side's input, so that its selection must be
exactly equal. Tolerances (fp32): rois atol 2e-3 px; softmax scores,
deltas and mask probabilities atol 1e-5; selections exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.models import detector as jdet
from detectorch_tpu.models import resnet as jresnet
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.eval import postprocess as tpost
from detectorch_tpu_torch.models import detector as tdet
from tests.torch_configs import both_configs

MASK, FASTER = "e2e_mask_rcnn_R-50-C4_2x", "e2e_faster_rcnn_R-50-C4_2x"
FAST = "fast_rcnn_R-50-C4_2x"
ROI_ATOL, ATOL = 2e-3, 1e-5
TCFG, PTCFG = both_configs(lambda c: c.TestConfig(detections_per_img=8, score_thresh=0.0))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _cfgs(preset):
    return both_configs(lambda c: c.PRESETS[preset].replace(
        compute_dtype="float32", rpn=c.RPNConfig(pre_nms_top_n=200, post_nms_top_n=16)))


def _inputs(seed=5):
    rng = np.random.RandomState(seed)
    images = (rng.randn(2, 64, 96, 3) * 4).astype(np.float32)
    scale = np.array([1.2, 1.1], np.float32)
    orig_h = np.array([50.0, 55.0], np.float32)
    orig_w = np.array([80.0, 85.0], np.float32)
    return images, scale, orig_h, orig_w


def _proposals(seed=6):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(0, 80, (2, 24))
    y1 = rng.uniform(0, 50, (2, 24))
    props = np.stack([x1, y1, x1 + rng.uniform(4, 90, (2, 24)),
                      y1 + rng.uniform(4, 60, (2, 24))], -1).astype(np.float32)
    valid = np.ones((2, 24), bool)
    valid[1, 18:] = False
    return props, valid


@pytest.fixture(scope="module", params=[MASK, FASTER, FAST])
def run(request):
    """Both packages' params, the inputs, the port's batched outputs and
    JAX's per-image outputs of one C4 preset."""
    cfg, pcfg = _cfgs(request.param)
    jp = jdet.init_params(cfg, seed=123)
    tp = params_from_jax(tdet.init_params(pcfg, seed=123))
    inputs = _inputs()
    extra = () if cfg.use_rpn else _proposals()
    out = tdet.make_inference_fn(pcfg, PTCFG)(tp, *map(_t, inputs + extra))
    jfwd = jax.jit(jdet.make_inference_fn(cfg, TCFG))
    jout = [jax.tree.map(np.asarray, jfwd(jp, *(jnp.asarray(a[b]) for a in inputs + extra)))
            for b in range(2)]
    return dict(cfg=cfg, pcfg=pcfg, jp=jp, tp=tp, inputs=inputs, extra=extra, out=out,
                jout=jout)


def test_c4_whole_path_matches_jax(run):
    cfg, out, jout = run["cfg"], run["out"], run["jout"]
    n = cfg.rpn.post_nms_top_n if cfg.use_rpn else 24
    assert out.rois.shape == (2, n, 4) and out.cls_scores.shape == (2, n, 81)
    assert out.detections.boxes.shape == (2, 16, 4)
    assert (out.masks is not None) == cfg.use_mask
    if cfg.use_mask:
        assert out.masks.shape == (2, 16, 14, 14)
    for b, jo in enumerate(jout):
        np.testing.assert_array_equal(out.roi_valid[b].numpy(), jo.roi_valid)
        assert jo.roi_valid.sum() > 8
        np.testing.assert_allclose(out.rois[b].numpy(), jo.rois, rtol=0, atol=ROI_ATOL)
        np.testing.assert_allclose(out.cls_scores[b].numpy(), jo.cls_scores, rtol=0, atol=ATOL)
        np.testing.assert_allclose(out.bbox_deltas[b].numpy(), jo.bbox_deltas, rtol=0, atol=ATOL)
        d, jd = out.detections, jo.detections
        assert int(d.valid[b].sum()) == int(jd.valid.sum()) >= 8
        np.testing.assert_allclose(np.sort(d.scores[b][d.valid[b]].numpy()),
                                   np.sort(jd.scores[jd.valid]), rtol=0, atol=ATOL)
        if cfg.use_mask:
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
    if not cfg.use_rpn:
        assert torch.equal(out.rois, _t(run["extra"][0]))


def test_c4_stages_on_jax_inputs_select_exactly(run):
    """The RPN on JAX's c4 map: the same proposals; the box branch on JAX's
    rois: the same scores; postprocess on them: the same detections; the
    mask branch and make_mask_fn on JAX's detections: the same masks."""
    cfg, pcfg, jp, tp, jout = run["cfg"], run["pcfg"], run["jp"], run["tp"], run["jout"]
    images, scale, orig_h, orig_w = run["inputs"]
    c4 = _t(np.concatenate([np.asarray(jresnet.c4_body(jp, jnp.asarray(images[b:b + 1])))
                            for b in range(2)]))
    with torch.inference_mode():
        if cfg.use_rpn:
            im_h, im_w = tdet.blob_bounds(pcfg, images.shape[1:3], _t(scale), _t(orig_h),
                                          _t(orig_w))
            props = tdet.rpn_proposals(tp, pcfg, c4, im_h, im_w, _t(scale))
            for b, jo in enumerate(jout):
                np.testing.assert_array_equal(props.valid[b].numpy(), jo.roi_valid)
                np.testing.assert_allclose(props.boxes[b].numpy(), jo.rois, rtol=0,
                                           atol=ROI_ATOL)
        cls, deltas, _ = tdet.box_branch(
            tp, pcfg, PTCFG, c4, _t(np.stack([j.rois for j in jout])),
            _t(np.stack([j.roi_valid for j in jout])), _t(scale), _t(orig_h), _t(orig_w))
    d = tpost.postprocess_detections(
        *(_t(np.stack([getattr(j, f) for j in jout]))
          for f in ("cls_scores", "bbox_deltas", "rois", "roi_valid")),
        _t(scale), _t(orig_h), _t(orig_w), PTCFG, pcfg.num_classes)
    for b, jo in enumerate(jout):
        np.testing.assert_allclose(cls[b].numpy(), jo.cls_scores, rtol=0, atol=ATOL)
        np.testing.assert_allclose(deltas[b].numpy(), jo.bbox_deltas, rtol=0, atol=ATOL)
        jd = jo.detections
        np.testing.assert_array_equal(d.valid[b].numpy(), jd.valid)
        np.testing.assert_array_equal(d.classes[b].numpy(), jd.classes)
        np.testing.assert_allclose(d.scores[b].numpy(), jd.scores, rtol=0, atol=1e-7)
        np.testing.assert_allclose(d.boxes[b].numpy(), jd.boxes, rtol=0, atol=1e-4)
    if not cfg.use_mask:
        return
    boxes = _t(np.stack([j.detections.boxes for j in jout]))
    classes = _t(np.stack([j.detections.classes for j in jout])).long()
    with torch.inference_mode():
        masks = tdet.mask_branch(tp, pcfg, c4, boxes, classes, _t(scale))
    masks_fn = tdet.make_mask_fn(pcfg)(tp, *map(_t, run["inputs"]), boxes, classes)
    jmask = jax.jit(jdet.make_mask_fn(cfg))
    for b, jo in enumerate(jout):
        np.testing.assert_allclose(masks[b].numpy(), jo.masks, rtol=0, atol=ATOL)
        jm, _ = jmask(jp, images[b], jnp.float32(scale[b]), jnp.float32(orig_h[b]),
                      jnp.float32(orig_w[b]), jo.detections.boxes, jo.detections.classes)
        np.testing.assert_allclose(masks_fn[b].numpy(), np.asarray(jm), rtol=0, atol=ATOL)


def test_c4_refuses_the_bf16_roi_align_tier():
    _, pcfg = _cfgs(MASK)
    assert pcfg.roi_align_precision == "high"  # the C4 presets' tier: exact fp32 here
    with pytest.raises(ValueError):
        tdet.make_inference_fn(pcfg.replace(roi_align_precision="bf16"), PTCFG)
    with pytest.raises(ValueError):
        tdet.make_mask_fn(pcfg.replace(roi_align_precision="bf16"))

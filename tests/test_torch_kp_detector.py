"""The port's keypoint inference against the JAX package: the keypoint
branch of ``make_inference_fn`` and ``make_keypoint_fn``, on the FPN
keypoint preset and on a C4 preset given a keypoint config (JAX runs the
keypoint branch on both).

fp32 compute, a small keypoint head (KeypointConfig(num_convs=2,
conv_dim=32)) behind full-width backbones, init_params(seed=123), a batch
of two images through the port's batched program against JAX's per-image
program; JAX's FPN RoIAlign is its exact gather (use_pallas_roi_align
False), as in tests/test_torch_detector.py. FPN: 96x128 images of noise
12, RPN 300 -> 64, 16 detections (+ 8 tie slots). C4: 64x96 images of
noise 4 (the random C4 trunk's magnitude, tests/test_torch_c4_detector.py),
RPN 200 -> 16, 8 detections.

As there, the whole path is compared where it is deterministic, and the
keypoint branch is then fed JAX's own features and detections. Tolerances
(fp32): the maximum logit of every keypoint within 1e-4 of the logits'
scale on the whole path (the detection boxes drift by up to ROI_ATOL and
move the RoIAlign samples; measured on C4: 1.2e-5) and 1e-5 on JAX's
features and detections; x/y within 1e-3 px and 1e-4 px, probabilities
rtol 1e-3 and 1e-4 (a sum over 3136 bins), except at a near-tied argmax:
random heads on thin boxes (a C4 box 4 px tall spans a quarter of a c4
cell) give heatmaps all but flat along one axis, where the two sides'
rounding picks different bins of equal maxima. Such keypoints keep their
logit within tolerance and may be at most 5% (whole path) and 2% (on JAX's
features) of those compared; measured, whole path 1 of 544 (FPN) and 3 of
272 (C4), on JAX's features 3 of 1088 and 5 of 544. Where the heatmaps
are the same, the decode picks JAX's bins exactly
(tests/test_torch_kp_ops.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.models import detector as jdet
from detectorch_tpu.models import fpn as jfpn
from detectorch_tpu.models import resnet as jresnet
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.models import detector as tdet
from tests.torch_configs import both_configs

ROI_ATOL = 2e-3
CASES = {
    "fpn": dict(preset="e2e_keypoint_rcnn_R-50-FPN_1x", rpn=(300, 64), dets=16,
                hw=(96, 128), noise=12.0, orig=((80.0, 106.0), (70.0, 110.0))),
    "c4": dict(preset="e2e_faster_rcnn_R-50-C4_2x", rpn=(200, 16), dets=8,
               hw=(64, 96), noise=4.0, orig=((50.0, 80.0), (55.0, 85.0))),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def kp_case(name):
    """(JAX's config, the port's, JAX's TestConfig, the port's, inputs) of
    a case."""
    c = CASES[name]
    cfg, pcfg = both_configs(lambda m: m.PRESETS[c["preset"]].replace(
        compute_dtype="float32", use_pallas_roi_align=False,
        rpn=m.RPNConfig(pre_nms_top_n=c["rpn"][0], post_nms_top_n=c["rpn"][1]),
        keypoint=m.KeypointConfig(num_convs=2, conv_dim=32)))
    tcfg, ptcfg = both_configs(lambda m: m.TestConfig(detections_per_img=c["dets"],
                                                      score_thresh=0.0))
    rng = np.random.RandomState(5)
    images = (rng.randn(2, *c["hw"], 3) * c["noise"]).astype(np.float32)
    scale = np.array([1.2, 1.1], np.float32)
    orig_h = np.array([o[0] for o in c["orig"]], np.float32)
    orig_w = np.array([o[1] for o in c["orig"]], np.float32)
    return cfg, pcfg, tcfg, ptcfg, (images, scale, orig_h, orig_w)


def jax_features(cfg, jp, images):
    """JAX's backbone features of a batch, as the port's branches take
    them: the NHWC pyramid [P2..P5] (FPN) or the c4 map (C4)."""
    if cfg.use_fpn:
        pyramids = [jfpn.fpn_neck(jp, jresnet.multilevel_body(jp, jnp.asarray(images[b:b + 1])))
                    for b in range(len(images))]
        return [_t(np.concatenate([np.asarray(p[lvl]) for p in pyramids])) for lvl in range(4)]
    return _t(np.concatenate([np.asarray(jresnet.c4_body(jp, jnp.asarray(images[b:b + 1])))
                              for b in range(len(images))]))


def compare_keypoints(got, exp, xy_atol, logit_rel, prob_rtol):
    """(..., P, 4) decoded keypoints of the same detections: every logit
    (its heatmap's maximum) within logit_rel of the logits' scale; x/y
    within xy_atol and probabilities within prob_rtol, except where a
    near-tied argmax tipped into another bin (x or y off by more than
    xy_atol while the maximum agrees). Returns (tipped, compared)."""
    got, exp = got.reshape(-1, 4), exp.reshape(-1, 4)
    scale = np.abs(exp[:, 2]).max()
    np.testing.assert_allclose(got[:, 2], exp[:, 2], rtol=0, atol=logit_rel * scale)
    tipped = (np.abs(got[:, :2] - exp[:, :2]) > xy_atol).any(axis=1)
    np.testing.assert_allclose(got[~tipped, 3], exp[~tipped, 3], rtol=prob_rtol)
    return int(tipped.sum()), len(got)


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    cfg, pcfg, tcfg, ptcfg, inputs = kp_case(request.param)
    jp = jdet.init_params(cfg, seed=123)
    tp = params_from_jax(tdet.init_params(pcfg, seed=123))
    out = tdet.make_inference_fn(pcfg, ptcfg)(tp, *map(_t, inputs))
    jfwd = jax.jit(jdet.make_inference_fn(cfg, tcfg))
    jout = [jax.tree.map(np.asarray, jfwd(jp, *(jnp.asarray(a[b]) for a in inputs)))
            for b in range(2)]
    return dict(cfg=cfg, pcfg=pcfg, jp=jp, tp=tp, inputs=inputs, out=out, jout=jout,
                k=ptcfg.detections_per_img + ptcfg.detections_tie_slack)


def test_kp_whole_path_matches_jax(run):
    """Keypoints of the detections both sides selected (same class, box
    within ROI_ATOL) agree; every decoded keypoint lies in its box. The
    drifting samples can tip a near-tied argmax into another bin: such a
    keypoint's logit (its heatmap's maximum) still agrees with JAX's, and
    at most 5% of the keypoints may move so."""
    out, jout, k = run["out"], run["jout"], run["k"]
    assert out.keypoints.shape == (2, k, 17, 4) and out.keypoints.dtype == torch.float32
    assert out.masks is None
    compared = moved = 0
    for b, jo in enumerate(jout):
        d, jd = out.detections, jo.detections
        assert int(d.valid[b].sum()) == int(jd.valid.sum()) > 0
        matched = 0
        for i in np.flatnonzero(d.valid[b].numpy()):
            same = (jd.classes == int(d.classes[b, i])) & jd.valid & (
                np.abs(jd.boxes - d.boxes[b, i].numpy()).max(axis=1) < ROI_ATOL)
            if not same.any():
                continue
            j = int(np.flatnonzero(same)[0])
            tipped, n = compare_keypoints(out.keypoints[b, i].numpy(), jo.keypoints[j], 1e-3,
                                          1e-4, 1e-3)
            moved += tipped
            compared += n
            matched += 1
        assert matched >= int(d.valid[b].sum()) // 2
        kx, ky = out.keypoints[b, ..., 0], out.keypoints[b, ..., 1]
        box = d.boxes[b][:, None]
        assert bool(((kx >= box[..., 0]) & (ky >= box[..., 1])).all())
    assert moved <= 0.05 * compared, (moved, compared)


def test_kp_branch_on_jax_detections_matches(run):
    """The keypoint branch on JAX's features and make_keypoint_fn on the
    images, both on JAX's valid detections: keypoints within 1e-4 px,
    logits within 1e-5 of their scale, probabilities rtol 1e-4; at most 2%
    of the keypoints on another bin of a near-tied argmax."""
    cfg, pcfg, jp, tp, jout = run["cfg"], run["pcfg"], run["jp"], run["tp"], run["jout"]
    images, scale, orig_h, orig_w = run["inputs"]
    boxes = np.stack([j.detections.boxes for j in jout])
    valid = np.stack([j.detections.valid for j in jout])
    exp = np.stack([j.keypoints for j in jout])
    with torch.inference_mode():
        got = tdet.keypoint_branch(tp, pcfg, jax_features(cfg, jp, images), _t(boxes), _t(scale))
    tipped, n = compare_keypoints(got.numpy()[valid], exp[valid], 1e-4, 1e-5, 1e-4)
    kp_fn = tdet.make_keypoint_fn(pcfg)(tp, *map(_t, run["inputs"]), _t(boxes))
    jkp = jax.jit(jdet.make_keypoint_fn(cfg))
    for b in range(2):
        jk, exact = jkp(jp, images[b], jnp.float32(scale[b]), jnp.float32(orig_h[b]),
                        jnp.float32(orig_w[b]), boxes[b])
        assert bool(exact)
        t, m = compare_keypoints(kp_fn[b].numpy()[valid[b]], np.asarray(jk)[valid[b]], 1e-4,
                                 1e-5, 1e-4)
        tipped, n = tipped + t, n + m
    assert tipped <= 0.02 * n, (tipped, n)


def test_make_keypoint_fn_needs_a_keypoint_config():
    _, pcfg, _, _, _ = kp_case("fpn")
    with pytest.raises(ValueError):
        tdet.make_keypoint_fn(pcfg.replace(keypoint=None))

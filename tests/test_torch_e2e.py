"""The port's e2e training functions against the JAX package's ``train/e2e.py``.

Setting of the JAX package's e2e tests: 64x128 images, full R-50-FPN
widths, SamplerConfig(rois_per_image=32), train counts pre 200 / post 64.
Both sides get the same numpy inputs, and the port gets the uniforms that
JAX's keys give (jax.random and torch draw different streams).

Tolerances, fp32:
  * selections and integers exact: ``random_keep_mask``, the labels of
    ``rpn_targets``, the rows, labels, validity and gt indices of
    ``sample_rois_device``, the scores and validity of the train-count
    decode;
  * regression targets rtol 1e-5, atol 1e-6 (XLA's log and the port's may
    differ in the last bit); decoded proposal boxes atol 1e-4 px (exp);
  * ``rpn_losses`` rtol 1e-5 (sums in another order);
  * ``mask_targets_device``: equal except where the interpolated value
    lies within 1e-4 of the 0.15 threshold (the two sides round the
    separable product in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.models import rpn as jrpn
from detectorch_tpu.train import e2e as JE
from detectorch_tpu.train.sampler import polys_to_mask_wrt_box
from detectorch_tpu_torch.models import detector as tdet
from detectorch_tpu_torch.train import e2e as E
from tests.torch_configs import both_configs

H, W = 64, 128
CFG, PCFG = both_configs(lambda c: c.PRESETS["e2e_mask_rcnn_R-50-FPN_2x"].replace(
    compute_dtype="float32"))
SAMPLER, PSAMPLER = both_configs(lambda c: c.SamplerConfig(rois_per_image=32))
PRE, POST = 200, 64
T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _anchors():
    """JAX's ``_level_anchors`` table for P2..P6 of a 64x128 blob."""
    shapes = [(H // 2 ** lvl, W // 2 ** lvl) for lvl in range(2, 7)]
    return np.concatenate([np.asarray(a) for a in JE._level_anchors(CFG, shapes)])


def _uniform(key, n, maxval=1.0):
    return np.asarray(jax.random.uniform(key, (n,), maxval=maxval))


def _gts(rng, b, g, n_valid):
    """(b, g) padded gt boxes inside a 64x128 image, n_valid[i] valid in
    image i; some small enough that no anchor reaches IoU 0.7 (the tie
    rule makes their positives), one pair identical (tied maxima)."""
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        n = n_valid[i]
        side = np.exp(rng.uniform(np.log(6), np.log(60), (n, 2)))
        xy = rng.uniform(0, 1, (n, 2)) * ([W, H] - side)
        boxes[i, :n] = np.round(np.concatenate([xy, xy + side], 1))
        valid[i, :n] = True
    boxes[0, 1] = boxes[0, 0]
    classes = np.where(valid, np.arange(1, g + 1)[None] % 80 + 1, 0).astype(np.int32)
    return boxes, classes, valid


@pytest.mark.parametrize("case", ["few", "all", "k_zero", "ties"])
def test_random_keep_mask_matches_jax(rng, monkeypatch, case):
    n = 500
    mask = rng.rand(2, n) > 0.4
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    us = np.stack([_uniform(k, n) for k in keys])
    if case == "ties":
        # coarse uniforms: many exact ties, resolved toward the lower index
        us = np.floor(us * 16) / 16
    k, max_keep = {"few": (17, 32), "all": (10_000, None), "k_zero": (0, 8),
                   "ties": (40, 64)}[case]
    got = E.random_keep_mask(T(mask), k, T(us), max_keep=max_keep).numpy()
    for i in range(2):
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape, u=us[i]: jnp.asarray(u))
        exp = np.asarray(JE.random_keep_mask(jnp.asarray(mask[i]), k, keys[i],
                                             max_keep=max_keep))
        np.testing.assert_array_equal(got[i], exp)
    assert got.sum(1).tolist() == [min(k, m) for m in mask.sum(1)]
    # a per-image k
    ks = np.array([5, 30])
    got = E.random_keep_mask(T(mask), T(ks), T(us), max_keep=64).numpy()
    assert got.sum(1).tolist() == ks.tolist() and not (got & ~mask).any()


@pytest.mark.parametrize("batch_size", [256, 16])
def test_rpn_targets_match_jax(rng, batch_size):
    anchors = _anchors()
    gt, _, valid = _gts(rng, 3, 10, [4, 1, 7])
    im_h = np.array([64.0, 50.0, 64.0], np.float32)
    im_w = np.array([128.0, 128.0, 97.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    u = {"pos": [], "neg": []}
    exp_labels, exp_targets = [], []
    for i, key in enumerate(keys):
        k1, k2 = jax.random.split(key)
        u["pos"].append(_uniform(k1, len(anchors)))
        u["neg"].append(_uniform(k2, len(anchors)))
        lab, tgt = JE.rpn_targets(jnp.asarray(anchors), jnp.asarray(gt[i]),
                                  jnp.asarray(valid[i]), im_h[i], im_w[i], key,
                                  batch_size=batch_size)
        exp_labels.append(np.asarray(lab))
        exp_targets.append(np.asarray(tgt))
    labels, targets = E.rpn_targets(T(anchors), T(gt), T(valid), T(im_h), T(im_w),
                                    T(np.stack(u["pos"])), T(np.stack(u["neg"])),
                                    batch_size=batch_size)
    np.testing.assert_array_equal(labels.numpy(), np.stack(exp_labels))
    pos = labels.numpy() == 1
    np.testing.assert_allclose(targets.numpy()[pos], np.stack(exp_targets)[pos],
                               rtol=1e-5, atol=1e-6)
    assert pos.sum() > 0 and (labels.numpy() == 0).sum() > 0
    assert ((labels.numpy() >= 0).sum(1) <= batch_size).all()


def test_rpn_losses_match_jax(rng):
    b, a = 2, 600
    logits = (rng.randn(b, a) * 2).astype(np.float32)
    deltas = (rng.randn(b, a, 4) * 0.3).astype(np.float32)
    labels = rng.choice([-1, 0, 1], (b, a), p=[0.6, 0.3, 0.1]).astype(np.int32)
    targets = (rng.randn(b, a, 4) * 0.3).astype(np.float32)
    cls, bbox = E.rpn_losses(T(logits), T(deltas), T(labels), T(targets))
    for i in range(b):
        jc, jb = JE.rpn_losses(logits[i], deltas[i], labels[i], targets[i])
        np.testing.assert_allclose(float(cls[i]), float(jc), rtol=1e-5)
        np.testing.assert_allclose(float(bbox[i]), float(jb), rtol=1e-5)


def test_sample_rois_device_matches_jax(rng):
    b, p, g = 2, 64, 8
    gt, classes, valid = _gts(rng, b, g, [3, 5])
    # proposals: jittered gts (foreground) and random boxes (background)
    base = gt[np.arange(b)[:, None], rng.randint(0, 3, (b, p))]
    props = base + rng.randn(b, p, 4).astype(np.float32) * 6
    props[:, 40:] = np.concatenate([rng.uniform(0, 100, (b, 24, 2)),
                                    rng.uniform(0, 100, (b, 24, 2)) + 20], -1)
    props = props.astype(np.float32)
    pvalid = rng.rand(b, p) > 0.1
    keys = jax.random.split(jax.random.PRNGKey(11), b)
    u = {k: [] for k in ("fg", "bg", "order")}
    exp = []
    for i, key in enumerate(keys):
        k1, k2, k3 = jax.random.split(key, 3)
        u["fg"].append(_uniform(k1, p + g))
        u["bg"].append(_uniform(k2, p + g))
        u["order"].append(_uniform(k3, p + g, maxval=0.5))
        exp.append(jax.tree.map(np.asarray, JE.sample_rois_device(
            jnp.asarray(props[i]), jnp.asarray(pvalid[i]), jnp.asarray(gt[i]),
            jnp.asarray(classes[i]), jnp.asarray(valid[i]), key, SAMPLER)))
    got = E.sample_rois_device(T(props), T(pvalid), T(gt), T(classes), T(valid),
                               T(np.stack(u["fg"])), T(np.stack(u["bg"])),
                               T(np.stack(u["order"])), PSAMPLER)
    for i, e in enumerate(exp):
        np.testing.assert_array_equal(got.rois[i].numpy(), e.rois)
        np.testing.assert_array_equal(got.labels[i].numpy(), e.labels)
        np.testing.assert_array_equal(got.valid[i].numpy(), e.valid)
        np.testing.assert_array_equal(got.gt_inds[i].numpy(), e.gt_inds)
        np.testing.assert_array_equal(got.targets[i, :, 0].numpy(), e.targets[:, 0])
        np.testing.assert_allclose(got.targets[i].numpy(), e.targets, rtol=1e-5, atol=1e-6)
        fg = e.labels > 0
        assert 0 < fg.sum() <= 8 and e.valid.sum() == 32 and not (fg[1:] & ~fg[:-1]).any()


def test_train_count_decode_matches_jax(rng):
    """``models.detector.fpn_proposals`` at train counts against JAX's
    per-level ``generate_proposals`` + ``collect_proposals``: P2 and P3 have
    more anchors than pre (200), P4 fewer than pre, P5 and P6 fewer than
    post (64)."""
    b = 2
    levels = list(range(2, 7))
    probs, deltas = [], []
    for lvl in levels:
        fh, fw = H // 2 ** lvl, W // 2 ** lvl
        probs.append(rng.uniform(0, 1, (b, fh, fw, 3)).astype(np.float32))
        deltas.append((rng.randn(b, fh, fw, 12) * 0.5).astype(np.float32))
    im_h = np.array([64.0, 52.0], np.float32)
    im_w = np.array([128.0, 100.0], np.float32)
    scale = np.array([1.0, 0.8], np.float32)
    got = tdet.fpn_proposals(PCFG.replace(rpn=dataclasses.replace(PCFG.rpn, min_size=2.0)),
                             [T(p) for p in probs], [T(d) for d in deltas], levels,
                             T(im_h), T(im_w), T(scale), PRE, POST)
    for i in range(b):
        lvl_props = []
        for lvl, p, d in zip(levels, probs, deltas):
            fh, fw = p.shape[1:3]
            lvl_props.append(jrpn.generate_proposals(
                jnp.asarray(p[i]), jnp.asarray(d[i]), im_h[i], im_w[i], scale[i],
                feat_stride=float(2 ** lvl), anchor_sizes=(32.0 * 2 ** (lvl - 2),),
                pre_nms_top_n=min(PRE, fh * fw * 3), post_nms_top_n=POST,
                nms_thresh=CFG.rpn.nms_thresh, min_size=2.0))
        exp = jax.tree.map(np.asarray, jrpn.collect_proposals(lvl_props, POST))
        np.testing.assert_array_equal(got.valid[i].numpy(), exp.valid)
        np.testing.assert_array_equal(got.scores[i].numpy(), exp.scores)
        np.testing.assert_allclose(got.boxes[i].numpy(), exp.boxes, rtol=0, atol=1e-4)
        assert exp.valid.sum() == POST


def _blob_polygon(rng, lo=20.0, hi=100.0):
    """A star-shaped polygon and its tight box (JAX's e2e tests' shape)."""
    cx, cy = rng.uniform(lo, hi, 2)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 12))
    rad = rng.uniform(8, 30) * (0.6 + 0.8 * rng.rand(12))
    px, py = cx + rad * np.cos(ang), cy + rad * np.sin(ang)
    return np.stack([px, py], 1).reshape(-1), np.array([px.min(), py.min(), px.max(), py.max()])


@pytest.mark.parametrize("resolution", [14, 28])
def test_mask_targets_device_match_jax(rng, resolution):
    b, g, r = 2, 5, 24
    mg = E.GT_RASTER_RES
    assert (mg, E.GT_RASTER_THRESH) == (JE.GT_RASTER_RES, JE.GT_RASTER_THRESH)
    rast = np.zeros((b, g, mg, mg), np.uint8)
    boxes = np.zeros((b, g, 4), np.float32)
    for i in range(b):
        for j in range(g):
            poly, box = _blob_polygon(rng)
            rast[i, j] = polys_to_mask_wrt_box([poly], box, mg)
            boxes[i, j] = box
    inds = rng.randint(0, g, (b, r)).astype(np.int32)
    gb = boxes[np.arange(b)[:, None], inds]
    size = np.tile(gb[..., 2:] - gb[..., :2], 2)
    rois = (gb + rng.uniform(-0.25, 0.25, (b, r, 4)) * size).astype(np.float32)
    got = E.mask_targets_device(T(rast), T(boxes), T(inds), T(rois), resolution).numpy()
    for i in range(b):
        exp = np.asarray(JE.mask_targets_device(jnp.asarray(rast[i]), jnp.asarray(boxes[i]),
                                                jnp.asarray(inds[i]), jnp.asarray(rois[i]),
                                                resolution))
        # the interpolated values in float64, from the fp32 sample coordinates
        gbi, ri = gb[i].astype(np.float32), rois[i]
        gw = np.maximum(gbi[:, 2] - gbi[:, 0], np.float32(1))
        gh = np.maximum(gbi[:, 3] - gbi[:, 1], np.float32(1))
        j = np.arange(resolution, dtype=np.float32) / np.float32(resolution)
        u = (ri[:, :1] + j * np.maximum(ri[:, 2:3] - ri[:, :1], np.float32(1)) - gbi[:, :1]) \
            * np.float32(mg) / gw[:, None]
        v = (ri[:, 1:2] + j * np.maximum(ri[:, 3:4] - ri[:, 1:2], np.float32(1)) - gbi[:, 1:2]) \
            * np.float32(mg) / gh[:, None]
        k = np.arange(mg)
        wu = np.maximum(0, 1 - np.abs(u.astype(np.float64)[..., None] - k))
        wv = np.maximum(0, 1 - np.abs(v.astype(np.float64)[..., None] - k))
        vals = np.einsum("rim,rmn,rjn->rij", wv, rast[i][inds[i]].astype(np.float64), wu)
        differ = got[i] != exp
        assert np.all(np.abs(vals[differ] - E.GT_RASTER_THRESH) < 1e-4), int(differ.sum())
        assert 0.1 < exp.mean() < 0.9

"""The port's box, anchor, FPN-level and NMS ops against the JAX package.

The same numpy inputs go through both; everything runs in fp32 on the CPU.
Selections (NMS indices, validity, top-k order) must be exactly equal.
Float results are held to rtol 1e-6 / atol 1e-4: the two frameworks round
the same fp32 formulas in the same order, so they differ by at most an ulp
of the operands (pixel coordinates up to ~1e4, where an ulp is ~1e-3 only
after exp() of the clipped deltas).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.models import rpn as jrpn
from detectorch_tpu.ops import anchors as janchors
from detectorch_tpu.ops import boxes as jboxes
from detectorch_tpu.ops import fpn_levels as jlevels
from detectorch_tpu.ops import nms as jnms
from detectorch_tpu_torch.models import rpn as trpn
from detectorch_tpu_torch.ops import anchors as tanchors
from detectorch_tpu_torch.ops import boxes as tboxes
from detectorch_tpu_torch.ops import fpn_levels as tlevels
from detectorch_tpu_torch.ops import nms as tnms
from tests.test_boxes import random_boxes

RTOL, ATOL = 1e-6, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, exp, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=rtol, atol=atol)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_bbox_transform_and_area(rng, weights):
    boxes = random_boxes(rng, 64)
    # deltas large enough that dw/dh hit BBOX_XFORM_CLIP
    deltas = (rng.randn(64, 4 * 5) * 8.0).astype(np.float32)
    _close(tboxes.bbox_transform(_t(boxes), _t(deltas), weights),
           jboxes.bbox_transform(jnp.asarray(boxes), jnp.asarray(deltas), weights))
    _close(tboxes.boxes_area(_t(boxes)), jboxes.boxes_area(jnp.asarray(boxes)))


def test_clip_and_filter_with_per_image_bounds(rng):
    # (B, N, 4K) tiled boxes with (B, 1) bounds, as the batched port uses them
    b, n, k = 3, 40, 5
    boxes = (rng.uniform(-100, 900, (b, n, 4 * k))).astype(np.float32)
    h = np.array([480.0, 600.0, 320.0], np.float32)
    w = np.array([640.0, 800.0, 500.0], np.float32)
    scale = np.array([1.0, 1.5, 0.8], np.float32)
    got = tboxes.clip_boxes(_t(boxes), _t(h)[:, None], _t(w)[:, None])
    for i in range(b):
        exp = jboxes.clip_boxes(jnp.asarray(boxes[i]), h[i], w[i])
        _close(got[i], exp)
    boxes4 = got.reshape(b, n * k, 4)
    ok = tboxes.filter_boxes_mask(boxes4, 16.0, _t(scale)[:, None], _t(h)[:, None],
                                  _t(w)[:, None])
    for i in range(b):
        exp = jboxes.filter_boxes_mask(jnp.asarray(boxes4[i].numpy()), 16.0, scale[i],
                                       h[i], w[i])
        np.testing.assert_array_equal(ok[i].numpy(), np.asarray(exp))


def test_bbox_overlaps(rng):
    a = random_boxes(rng, 50, size=200.0)
    b = random_boxes(rng, 70, size=200.0)
    b[:5] = a[:5]  # identical pairs: IoU exactly 1
    _close(tboxes.bbox_overlaps(_t(a), _t(b)),
           jboxes.bbox_overlaps(jnp.asarray(a), jnp.asarray(b)), atol=1e-6)


@pytest.mark.parametrize("stride,sizes,ratios,hw", [
    (16.0, (32, 64, 128, 256, 512), (0.5, 1.0, 2.0), (5, 7)),   # C4 table
    (4.0, (32.0,), (0.5, 1.0, 2.0), (13, 21)),                   # FPN P2
    (64.0, (512.0,), (0.5, 1.0, 2.0), (2, 3)),                   # FPN P6
])
def test_anchors_equal(stride, sizes, ratios, hw):
    np.testing.assert_array_equal(tanchors.generate_anchors(stride, sizes, ratios),
                                  janchors.generate_anchors(stride, sizes, ratios))
    np.testing.assert_array_equal(tanchors.shifted_anchors(*hw, stride, sizes, ratios),
                                  janchors.shifted_anchors(*hw, stride, sizes, ratios))


def test_fpn_levels_equal(rng):
    rois = random_boxes(rng, 500, size=1300.0)
    # tiny and huge rois clamp to the end levels
    rois[:3] = [[0, 0, 1, 1], [5, 5, 5, 5], [0, 0, 1300, 1300]]
    got = tlevels.map_rois_to_fpn_levels(_t(rois), 2, 5, 224.0, 4)
    exp = jlevels.map_rois_to_fpn_levels(jnp.asarray(rois), 2, 5, 224.0, 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert set(np.unique(got.numpy())) == {2, 3, 4, 5}


def _nms_pair(boxes, scores, max_out, thresh, valid=None):
    """(port, jax) kept indices + validity for one row."""
    ti, tv = tnms.nms(_t(boxes), _t(scores), max_out, thresh,
                      None if valid is None else _t(valid))
    ji, jv = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), max_out, thresh,
                      None if valid is None else jnp.asarray(valid))
    return (ti.numpy(), tv.numpy()), (np.asarray(ji), np.asarray(jv))


def _assert_same_selection(port, ref):
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_array_equal(port[0], ref[0])


# N < 192 takes JAX's nms_loop, N >= 192 its blocked form; the port has only
# the blocked form and must agree with both
@pytest.mark.parametrize("n,max_out,thresh", [
    (60, 30, 0.5), (150, 200, 0.7), (300, 100, 0.5), (1000, 1000, 0.7), (700, 50, 0.3),
])
def test_nms_random_boxes(rng, n, max_out, thresh):
    boxes = random_boxes(rng, n, size=300.0)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) > 0.2
    port, ref = _nms_pair(boxes, scores, max_out, thresh, valid)
    assert port[1].sum() > 0
    _assert_same_selection(port, ref)


def test_nms_suppresses_at_equal_iou():
    # IoU of these two boxes is exactly 0.5 under the +1 convention
    boxes = np.array([[0, 0, 9, 9], [0, 0, 9, 19]], np.float32)
    scores = np.array([0.9, 0.8], np.float32)
    idx, ok = tnms.nms(_t(boxes), _t(scores), 2, 0.5)
    assert ok.tolist() == [True, False] and idx.tolist() == [0, 0]


@pytest.mark.parametrize("seed", range(4))
def test_nms_small_ties(seed):
    # the cases of tests/test_ties.py: quantised scores, higher index first
    rng = np.random.RandomState(seed)
    boxes = random_boxes(rng, 12, size=60.0)
    scores = rng.choice([0.2, 0.5, 0.9], size=12).astype(np.float32)
    _assert_same_selection(*_nms_pair(boxes, scores, 12, 0.5))


def test_nms_large_ties(rng):
    boxes = random_boxes(rng, 400, size=250.0)
    scores = rng.choice(np.linspace(0.1, 1.0, 8), size=400).astype(np.float32)
    _assert_same_selection(*_nms_pair(boxes, scores, 400, 0.5))


def test_nms_duplicate_boxes(rng):
    base = random_boxes(rng, 30, size=100.0)
    boxes = np.concatenate([base, base])
    scores = np.full(60, 0.7, np.float32)
    port, ref = _nms_pair(boxes, scores, 60, 0.5)
    _assert_same_selection(port, ref)
    assert (port[0][port[1]] >= 30).all()  # the higher-index copies win


def test_batched_nms(rng):
    m, n = 6, 260
    boxes = np.stack([random_boxes(rng, n, size=200.0) for _ in range(m)])
    scores = rng.choice(np.linspace(0.05, 1.0, 20), size=(m, n)).astype(np.float32)
    valid = rng.rand(m, n) > 0.1
    valid[2] = False  # an all-invalid row
    ti, tv = tnms.batched_nms(_t(boxes), _t(scores), 90, 0.6, valid=_t(valid))
    ji, jv = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), 90, 0.6,
                              valid=jnp.asarray(valid))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert not tv[2].any()


def test_topk_stable_matches_lax_top_k(rng):
    x = rng.choice([0.1, 0.5, 0.5, 0.9, -np.inf], size=(4, 300)).astype(np.float32)
    vals, idx = tnms.topk_stable(_t(x), 120)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 120)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_collect_proposals_tie_order(rng):
    n_lvl, per, top = 3, 50, 60
    lvl_boxes = [random_boxes(rng, per, size=200.0) for _ in range(n_lvl)]
    lvl_scores = [rng.choice([0.25, 0.5, 0.75], size=per).astype(np.float32)
                  for _ in range(n_lvl)]
    lvl_valid = [rng.rand(per) > 0.3 for _ in range(n_lvl)]
    got = trpn.collect_proposals(
        [trpn.Proposals(_t(b), _t(s), _t(v))
         for b, s, v in zip(lvl_boxes, lvl_scores, lvl_valid)], top)
    exp = jrpn.collect_proposals(
        [jrpn.Proposals(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v))
         for b, s, v in zip(lvl_boxes, lvl_scores, lvl_valid)], top)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(exp.valid))
    ok = got.valid.numpy()
    np.testing.assert_array_equal(got.boxes.numpy()[ok], np.asarray(exp.boxes)[ok])
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(exp.scores))

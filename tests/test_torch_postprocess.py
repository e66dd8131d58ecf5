"""Soft-NMS, box voting and the postprocess branches that use them, against
the JAX package on the same numpy inputs.

Selections (indices, validity, classes) must be equal; scores and boxes
agree within atol 1e-5 (the same fp32 formulas, with sums — the voting
weights, the vote's weighted mean — taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.eval import postprocess as jpost
from detectorch_tpu.ops import boxes as jboxes
from detectorch_tpu.ops import nms as jnms
from detectorch_tpu_torch.eval import postprocess as tpost
from detectorch_tpu_torch.ops import boxes as tboxes
from detectorch_tpu_torch.ops import nms as tnms
from tests.torch_configs import both_configs

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _clustered_boxes(rng, m, n, extent=60.0):
    """(M, N, 4) boxes in a few overlapping clusters, so that suppression
    and voting have work to do."""
    centers = rng.uniform(10, extent - 10, (m, 4, 2))
    pick = centers[np.arange(m)[:, None], rng.randint(0, 4, (m, n))]
    ctr = pick + rng.randn(m, n, 2) * 2.0
    wh = rng.uniform(6, 18, (m, n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("method", ["linear", "gaussian", "hard"])
def test_soft_nms_matches_jax(rng, method):
    m, n, k = 5, 48, 20
    boxes = _clustered_boxes(rng, m, n)
    scores = rng.uniform(0.0, 1.0, (m, n)).astype(np.float32)
    valid = rng.rand(m, n) > 0.15
    valid[3] = False  # a row with no candidate
    got = tnms.batched_soft_nms(_t(boxes), _t(scores), k, sigma=0.5, overlap_thresh=0.3,
                                score_thresh=0.05, method=method, valid=_t(valid))
    n_kept = 0
    for i in range(m):
        exp = jnms.soft_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), k, sigma=0.5,
                            overlap_thresh=0.3, score_thresh=0.05, method=method,
                            valid=jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(exp[0]))
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(exp[2]))
        np.testing.assert_allclose(got[1][i].numpy(), np.asarray(exp[1]), rtol=0, atol=ATOL)
        n_kept += int(np.asarray(exp[2]).sum())
    assert not got[2][3].any() and 0 < n_kept < m * k  # some decayed out


def test_soft_nms_ties_take_the_first_maximum():
    boxes = torch.tensor([[[0.0, 0, 10, 10], [50, 50, 60, 60], [0, 0, 10, 10]]])
    scores = torch.tensor([[0.5, 0.9, 0.9]])
    idx, sc, ok = tnms.batched_soft_nms(boxes, scores, 3, method="hard", score_thresh=0.0)
    exp = jnms.soft_nms(jnp.asarray(boxes[0].numpy()), jnp.asarray(scores[0].numpy()), 3,
                        method="hard", score_thresh=0.0)
    # 1 before 2 (equal scores), then 2's twin 0 survives at score 0 (0 is
    # not below score_thresh 0)
    assert idx[0].tolist() == np.asarray(exp[0]).tolist() == [1, 2, 0]
    assert ok[0].tolist() == np.asarray(exp[2]).tolist() == [True, True, True]
    assert sc[0].tolist() == np.asarray(exp[1]).tolist() == [np.float32(0.9)] * 2 + [0.0]


@pytest.mark.parametrize("method", ["ID", "TEMP_AVG", "AVG", "IOU_AVG", "GENERALIZED_AVG",
                                    "QUASI_SUM"])
def test_box_voting_matches_jax(rng, method):
    m, n, k = 4, 40, 12
    all_boxes = _clustered_boxes(rng, m, n)
    all_valid = rng.rand(m, n) > 0.2
    all_scores = np.where(all_valid, rng.uniform(0.05, 1.0, (m, n)), 0.0).astype(np.float32)
    top = rng.randint(0, n, (m, k))
    top_boxes = np.take_along_axis(all_boxes, top[..., None], 1)
    top_scores = np.take_along_axis(all_scores, top, 1)
    beta = 1.0 if method in ("ID", "AVG", "IOU_AVG") else 2.0
    vb, vs = tboxes.box_voting(_t(top_boxes), _t(top_scores), _t(all_boxes), _t(all_scores),
                               _t(all_valid), 0.5, method, beta)
    for i in range(m):
        eb, es = jboxes.box_voting(top_boxes[i], top_scores[i], all_boxes[i], all_scores[i],
                                   all_valid[i], 0.5, method, beta)
        np.testing.assert_allclose(vb[i].numpy(), np.asarray(eb), rtol=0, atol=ATOL)
        np.testing.assert_allclose(vs[i].numpy(), np.asarray(es), rtol=0, atol=ATOL)
    with pytest.raises(NotImplementedError):
        tboxes.box_voting(_t(top_boxes), _t(top_scores), _t(all_boxes), _t(all_scores),
                          _t(all_valid), 0.5, "MEDIAN")


@pytest.mark.parametrize("branch", [
    {"soft_nms": True},
    {"soft_nms": True, "soft_nms_method": "gaussian"},
    {"do_bbox_vote": True},
    {"do_bbox_vote": True, "bbox_vote_method": "IOU_AVG"},
    {"soft_nms": True, "do_bbox_vote": True},
])
def test_postprocess_branches_match_jax(rng, branch):
    b, n, c = 2, 40, 5
    tcfg, ptcfg = both_configs(lambda c: c.TestConfig(
        detections_per_img=8, detections_tie_slack=4, score_thresh=0.05, **branch))
    rois = _clustered_boxes(rng, b, n, extent=90.0)
    logits = rng.randn(b, n, c).astype(np.float32) * 2
    scores = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    deltas = (rng.randn(b, n, 4 * c) * 0.3).astype(np.float32)
    valid = rng.rand(b, n) > 0.1
    scale = np.array([1.5, 1.25], np.float32)
    oh = np.array([60.0, 70.0], np.float32)
    ow = np.array([64.0, 72.0], np.float32)
    d = tpost.postprocess_detections(_t(scores), _t(deltas), _t(rois), _t(valid), _t(scale),
                                     _t(oh), _t(ow), ptcfg, c)
    for i in range(b):
        jd = jpost.postprocess_detections(
            jnp.asarray(scores[i]), jnp.asarray(deltas[i]), jnp.asarray(rois[i]),
            jnp.asarray(valid[i]), jnp.float32(scale[i]), jnp.float32(oh[i]),
            jnp.float32(ow[i]), tcfg, c)
        np.testing.assert_array_equal(d.valid[i].numpy(), np.asarray(jd.valid))
        np.testing.assert_array_equal(d.classes[i].numpy(), np.asarray(jd.classes))
        np.testing.assert_allclose(d.scores[i].numpy(), np.asarray(jd.scores), rtol=0, atol=ATOL)
        np.testing.assert_allclose(d.boxes[i].numpy(), np.asarray(jd.boxes), rtol=0, atol=ATOL)
        assert int(np.asarray(jd.valid).sum()) >= 8

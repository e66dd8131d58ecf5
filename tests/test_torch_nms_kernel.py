"""The CUDA NMS kernel (``ops/cuda/nms_kernel``, ``csrc/nms.cu``) against
the blocked path and JAX.

On the CPU, the numpy mirror of the kernel's two stages (the 64-bit IoU
words, the chunked greedy scan, the stop at max_out) runs on
``ops/nms.sort_rows``'s output and must equal ``batched_nms_blocked`` and
JAX's ``nms_blocked`` bit for bit: the kept indices and their validity.

On a card (marker ``cuda``; skipped without one) the kernel itself must
equal ``batched_nms_blocked`` run on the card, bit for bit, at the main
path's shapes and on the CPU cases, with no host sync and two launches a
call. The card has no JAX: this file imports it only inside the CPU test,
and ``--noconftest`` keeps ``tests/conftest.py`` (which imports it) out:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_nms_kernel.py
"""

import numpy as np
import pytest
import torch

from detectorch_tpu_torch.ops import boxes as tboxes
from detectorch_tpu_torch.ops import nms as tnms
from detectorch_tpu_torch.ops.cuda import nms_kernel


def _boxes(rng, shape, size=600.0):
    """Random xyxy boxes: corners in [0, size), sides up to size / 2."""
    xy = rng.uniform(0, size, shape + (2,))
    wh = rng.uniform(1, size / 2, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _clustered(rng, m, n, height=800.0, width=1333.0, objects=12):
    """Proposal-like boxes: each jittered around one of a few objects, by up
    to a quarter of its size, so suppression chains run through the rows."""
    centre = rng.uniform(0, 1, (m, objects, 2)) * [width, height]
    half = np.exp(rng.uniform(np.log(8), np.log(250), (m, objects, 2)))
    pick = rng.randint(0, objects, (m, n))
    c = np.take_along_axis(centre, pick[..., None], 1)
    h = np.take_along_axis(half, pick[..., None], 1) * rng.uniform(0.75, 1.25, (m, n, 2))
    c = c + (rng.uniform(-0.25, 0.25, (m, n, 2)) * h)
    return np.concatenate([c - h, c + h], -1).astype(np.float32)


def _edge_pairs(rng, thresh, count=20000):
    """Pairs of boxes whose fp32 IoU (``ops/boxes.bbox_overlaps``) is
    exactly fp32(thresh), one ulp above it, or one ulp below it: box b is
    box a narrowed to about thresh of its width, jittered by a few ulps.
    Returns {"at"|"above"|"below": (a (k, 4), b (k, 4))}."""
    t = np.float32(thresh)
    wh = rng.uniform(40, 300, (count, 2)).astype(np.float32)
    a = np.zeros((count, 4), np.float32)
    a[:, 2:] = wh
    x = (t * (wh[:, 0] + np.float32(1)) - np.float32(1)).astype(np.float32)
    b = a.copy()
    b[:, 2] = (x.view(np.int32) + rng.randint(-8, 9, count)).astype(np.int32).view(np.float32)
    iou = tboxes.bbox_overlaps(torch.from_numpy(a)[:, None],
                               torch.from_numpy(b)[:, None])[:, 0, 0].numpy()
    out = {}
    for name, v in (("at", t), ("above", np.nextafter(t, np.float32(1))),
                    ("below", np.nextafter(t, np.float32(0)))):
        hit = iou == v
        assert hit.sum() >= 8, f"no pair at IoU {name} {thresh}"
        out[name] = (a[hit], b[hit])
    return out


# (earlier, later) sorted positions of a pair: one chunk, across a word
# boundary, first and last of a row, far apart
_PAIR_RANKS = ((0, 1), (63, 64), (62, 65), (10, 90), (0, 99), (64, 127), (126, 127), (5, 6))


def _threshold_rows(rng, thresh, n=128):
    """One row per edge pair (8 at, 8 above, 8 below the threshold): the
    pair at the origin, at the ranks of _PAIR_RANKS, among n - 2 boxes far
    to the right. Returns (boxes, scores, later, suppressed): per row the
    input index of the pair's later box, and whether it must go."""
    pairs = _edge_pairs(rng, thresh)
    rows, scores, later, suppressed = [], [], [], []
    for name, (a, b) in pairs.items():
        for k, (r1, r2) in enumerate(_PAIR_RANKS):
            row = _boxes(rng, (n,), 400.0)
            row[:, [0, 2]] += 1000.0
            rank = np.delete(np.arange(n), [r1, r2])
            rank = np.insert(rank, 0, [r1, r2])  # the pair first, at ranks r1, r2
            first, second = (a[k], b[k]) if k % 2 else (b[k], a[k])
            row[:2] = first, second
            perm = rng.permutation(n)  # input order unrelated to rank
            s = (n - rank).astype(np.float32) / n
            rows.append(row[perm])
            scores.append(s[perm])
            later.append(int(np.flatnonzero(perm == 1)[0]))
            suppressed.append(name != "below")
    return np.stack(rows), np.stack(scores), later, suppressed


def _case(name):
    """(boxes (M, N, 4), scores (M, N), valid (M, N) or None, max_out,
    thresh) of a named case; inputs from a fixed seed."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "random":
        return _boxes(rng, (3, 300), 300.0), rng.rand(3, 300).astype(np.float32), \
            rng.rand(3, 300) > 0.2, 100, 0.7
    if name == "ties":  # quantised scores: ties go to the higher input index
        return _boxes(rng, (2, 256), 250.0), \
            rng.choice(np.linspace(0.1, 1.0, 8), (2, 256)).astype(np.float32), None, 256, 0.5
    if name == "duplicates":
        base = _boxes(rng, (2, 40), 100.0)
        return np.concatenate([base, base], 1), np.full((2, 80), 0.7, np.float32), None, 80, 0.5
    if name.startswith("threshold"):
        boxes, scores, _, _ = _threshold_rows(rng, float(name.split("_")[1]))
        return boxes, scores, None, 128, float(name.split("_")[1])
    if name == "invalid_and_padded":
        boxes = _boxes(rng, (4, 200))
        valid = rng.rand(4, 200) > 0.9
        valid[1] = False  # a row with no live box
        valid[2, :100] = False
        return boxes, rng.rand(4, 200).astype(np.float32), valid, 50, 0.6
    if name == "n65":  # N not a multiple of 64
        return _clustered(rng, 3, 65), rng.rand(3, 65).astype(np.float32), None, 30, 0.5
    if name == "n_below_max_out":
        return _clustered(rng, 2, 50), rng.rand(2, 50).astype(np.float32), None, 80, 0.5
    if name == "n1":
        return _boxes(rng, (3, 1)), rng.rand(3, 1).astype(np.float32), None, 5, 0.5
    if name == "n0":
        return np.zeros((2, 0, 4), np.float32), np.zeros((2, 0), np.float32), None, 5, 0.5
    if name == "c4_proposals":  # C4: 6000 -> 1000 per image at 0.7, reduced
        return _clustered(rng, 2, 600), rng.rand(2, 600).astype(np.float32), None, 100, 0.7
    if name == "fpn_proposals":  # FPN: 5 levels padded to the widest, reduced
        valid = np.ones((10, 160), bool)
        valid[4::5, 40:] = False  # the coarsest level has fewer anchors
        return _clustered(rng, 10, 160), rng.rand(10, 160).astype(np.float32), valid, 100, 0.7
    if name == "postprocess":  # (image x class) rows, score threshold 0.05, 100 + 8 slots
        scores = (rng.rand(16, 120) ** 4).astype(np.float32)
        return _clustered(rng, 16, 120), scores, scores > 0.05, 108, 0.5
    raise KeyError(name)


CPU_CASES = ("random", "ties", "duplicates", "threshold_0.7", "threshold_0.5", "threshold_0.3",
             "invalid_and_padded", "n65", "n_below_max_out", "n1", "n0", "c4_proposals",
             "fpn_proposals", "postprocess")


def _torch(case, device="cpu"):
    boxes, scores, valid, max_out, thresh = case
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (boxes, scores)]
    return t[0], t[1], None if valid is None else torch.from_numpy(valid).to(device), \
        max_out, thresh


@pytest.mark.parametrize("name", CPU_CASES)
def test_kernel_mirror_matches_blocked_and_jax(name):
    import jax
    import jax.numpy as jnp

    from detectorch_tpu.ops import nms as jnms

    case = _case(name)
    boxes, scores, valid, max_out, thresh = _torch(case)
    exp_idx, exp_ok = tnms.batched_nms_blocked(boxes, scores, max_out, thresh, valid)
    sboxes, alive, order = tnms.sort_rows(boxes, scores, valid)
    got_idx, got_ok = nms_kernel.nms_mirror(sboxes, alive, order, thresh, max_out)
    np.testing.assert_array_equal(got_ok, exp_ok.numpy())
    np.testing.assert_array_equal(got_idx, exp_idx.numpy())
    if name.startswith("threshold"):
        # XLA's fused CPU IoU rounds up to a few ulps apart from the op-by-op
        # fp32 of ops/boxes.bbox_overlaps (0.6999998 for one pair that both
        # PyTorch and the kernel read as fp32(0.7)), so on rows built to sit
        # at the threshold's ulp JAX decides otherwise and is no reference.
        # Instead: each row's pair loses its later box at IoU = thresh and
        # one ulp above it, and keeps it one ulp below
        _, _, later, suppressed = _threshold_rows(np.random.RandomState(sum(map(ord, name))),
                                                  thresh)
        for r in range(len(later)):
            assert (later[r] in got_idx[r][got_ok[r]]) != suppressed[r], r
    elif boxes.shape[1]:  # JAX's nms_blocked takes no empty row (its dynamic_slice refuses)
        b, s, v = case[:3]
        v = np.ones(s.shape, bool) if v is None else v
        ji, jv = jax.vmap(lambda b, s, v: jnms.nms_blocked(b, s, max_out, thresh, valid=v))(
            jnp.asarray(b), jnp.asarray(s), jnp.asarray(v))
        np.testing.assert_array_equal(got_ok, np.asarray(jv))
        np.testing.assert_array_equal(got_idx, np.asarray(ji))


def _strided(device="cpu"):
    """Postprocess's (image x class) rows at batch 1: boxes, scores and
    valid as views whose rows are not contiguous."""
    rng = np.random.RandomState(5)
    boxes = torch.from_numpy(_clustered(rng, 1, 81 * 300).reshape(1, 300, 81, 4)).to(device)
    scores = torch.from_numpy(rng.rand(1, 300, 81).astype(np.float32) ** 4).to(device)
    cls_boxes = boxes[:, :, 1:].permute(0, 2, 1, 3).reshape(80, 300, 4)
    cls_scores = scores[:, :, 1:].permute(0, 2, 1).reshape(80, 300)
    return cls_boxes, cls_scores, cls_scores > 0.05, 108, 0.5


def test_sort_rows_makes_strided_rows_contiguous():
    boxes, scores, valid, max_out, thresh = _strided()
    assert not scores.is_contiguous() and not boxes.is_contiguous()
    sboxes, alive, order = tnms.sort_rows(boxes, scores, valid)
    assert sboxes.is_contiguous() and alive.is_contiguous() and order.is_contiguous()
    exp_idx, exp_ok = tnms.batched_nms_blocked(boxes, scores, max_out, thresh, valid)
    got_idx, got_ok = nms_kernel.nms_mirror(sboxes, alive, order, thresh, max_out)
    np.testing.assert_array_equal(got_ok, exp_ok.numpy())
    np.testing.assert_array_equal(got_idx, exp_idx.numpy())


# the widest row the kernel takes: the scan's shared memory at its limit
WIDEST = nms_kernel._MAX_WORDS * nms_kernel.WORD

# the main path's three NMS shapes (rows x candidates, threshold, slots),
# FPN's training count per level, the widest row, and the CPU cases
CARD_CASES = ("c4_proposals_8x6000", "fpn_proposals_40x1000", "postprocess_640x1000",
              "fpn_train_40x12000", f"widest_1x{WIDEST}") + CPU_CASES


def _card_case(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "c4_proposals_8x6000":
        return _clustered(rng, 8, 6000, objects=40), rng.rand(8, 6000).astype(np.float32), \
            None, 1000, 0.7
    if name in ("fpn_proposals_40x1000", "fpn_train_40x12000"):
        n = 1000 if name.startswith("fpn_proposals") else 12000
        valid = np.ones((40, n), bool)
        valid[4::5, 819:] = False  # P6 holds 13 x 21 x 3 anchors at 832 x 1344
        return _clustered(rng, 40, n, objects=40), rng.rand(40, n).astype(np.float32), valid, \
            1000 if n == 1000 else 2000, 0.7
    if name == "postprocess_640x1000":
        scores = (rng.rand(640, 1000) ** 4).astype(np.float32)
        return _clustered(rng, 640, 1000, objects=20), scores, scores > 0.05, 108, 0.5
    if name.startswith("widest"):
        return _clustered(rng, 1, WIDEST, height=8000.0, width=8000.0, objects=4000), \
            rng.rand(1, WIDEST).astype(np.float32), None, 2000, 0.7
    return _case(name)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_kernel_matches_blocked_on_the_card(card, name):
    boxes, scores, valid, max_out, thresh = _torch(_card_case(name), card)
    nms_kernel.batched_nms_kernel.build()
    exp_idx, exp_ok = tnms.batched_nms_blocked(boxes, scores, max_out, thresh, valid)
    torch.cuda.synchronize(card)
    launches = nms_kernel.batched_nms_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_idx, got_ok = tnms.batched_nms(boxes, scores, max_out, thresh, valid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ran = boxes.shape[1] > 0
    assert nms_kernel.batched_nms_kernel.launches == launches + (2 if ran else 0)
    assert torch.equal(got_ok, exp_ok)
    assert torch.equal(got_idx, exp_idx)


@pytest.mark.cuda
def test_kernel_refuses_a_row_past_its_shared_memory(card):
    boxes, scores, _, max_out, thresh = _torch(_card_case("c4_proposals_8x6000"), card)
    wide = boxes[:1, :1].expand(1, WIDEST + 1, 4).contiguous()
    with pytest.raises(ValueError, match="at most"):
        tnms.batched_nms(wide, scores[:1, :1].expand(1, WIDEST + 1).contiguous(), max_out,
                         thresh)


@pytest.mark.cuda
def test_kernel_takes_strided_rows(card):
    boxes, scores, valid, max_out, thresh = _strided(card)
    exp_idx, exp_ok = tnms.batched_nms_blocked(boxes, scores, max_out, thresh, valid)
    got_idx, got_ok = tnms.batched_nms(boxes, scores, max_out, thresh, valid)
    assert torch.equal(got_ok, exp_ok)
    assert torch.equal(got_idx, exp_idx)

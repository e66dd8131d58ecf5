"""Fixed-shape greedy NMS, batched over a leading axis.

Port of ``detectorch_tpu/ops/nms.py`` (``nms_blocked``): exact Detectron
semantics — suppress at IoU >= thresh with +1 areas, and on equal scores the
HIGHER input index is processed first (the reference's stable reading of
``scores.argsort()[::-1]``). The JAX dispatcher sends N < 192 to an argmax
loop with the same semantics; the blocked form alone serves every N here.

``batched_nms`` chooses by where the tensors lie, with no option:

  * CPU tensors run ``batched_nms_blocked``, JAX's blocked form, which the
    tests hold to ``nms_blocked``. Greedy suppression over the score-sorted
    order is a DAG recurrence (box j dies iff a kept earlier box overlaps
    it), evaluated in blocks of 128: each block resolves its internal
    dependencies by iterating the antitone map k -> base & ~(k A) to its
    unique fixpoint, then suppresses all later boxes with one vectorised
    IoU pass. On a card each fixpoint test would be a host sync.
  * CUDA tensors sort their rows here (``sort_rows``) and launch the CUDA
    kernel (``ops/cuda/nms_kernel``, ``csrc/nms.cu``): one launch writes
    the IoU bitmask of every pair, a second walks each row's greedy order
    on the device. The host never waits; the outputs are the blocked
    form's, bit for bit.

Shapes are static: (M, N) in, (M, max_out) out with a validity mask.
``batched_soft_nms`` ports JAX's ``soft_nms`` loop in the same batched form.
"""

from __future__ import annotations

import torch

from detectorch_tpu_torch.ops.boxes import bbox_overlaps
from detectorch_tpu_torch.ops.cuda.nms_kernel import batched_nms_kernel

NEG_INF = float("-inf")


def topk_stable(x, k: int):
    """``jax.lax.top_k`` semantics: the k largest along the last axis,
    descending, ties broken toward the lower index (``torch.topk`` promises
    no order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def batched_nms(boxes, scores, max_out: int, iou_thresh: float, valid=None,
                block: int = 128):
    """Greedy NMS over each row of a batch.

    Args:
      boxes: (M, N, 4) xyxy; scores: (M, N), already in the order-defining
        score space; valid: optional (M, N) bool — False entries can never
        be selected nor suppress.
      max_out: number of output slots per row; iou_thresh: suppress when
        IoU >= thresh; block: the blocked form's block (CPU tensors).

    Returns:
      keep_idx: (M, max_out) int64 indices into N (0 for padded slots).
      keep_valid: (M, max_out) bool.

    CPU tensors run ``batched_nms_blocked``; CUDA tensors the kernel, with
    no host sync (module docstring).
    """
    if boxes.device.type == "cpu":
        return batched_nms_blocked(boxes, scores, max_out, iou_thresh, valid, block)
    return batched_nms_kernel(*sort_rows(boxes, scores, valid), iou_thresh, max_out)


def sort_rows(boxes, scores, valid=None):
    """Each row by descending score with ties toward the HIGHER input index
    (a stable descending sort of the reversed rows, indices mapped back).
    Returns the sorted boxes (M, N, 4) fp32, ``alive`` (M, N) (a valid
    entry with a score above -inf: the others can neither keep nor
    suppress) and the permutation ``order`` (M, N) int64 back to input
    indices, all contiguous whatever the inputs' strides (postprocess's
    (image x class) rows of one image are a transposed view)."""
    boxes = boxes.float()
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m, n = scores.shape
    sort_scores, rev = torch.sort(scores.flip(-1), dim=-1, descending=True, stable=True)
    order = (n - 1) - rev
    sboxes = torch.gather(boxes, 1, order[..., None].expand(m, n, 4))
    return sboxes.contiguous(), (sort_scores > NEG_INF).contiguous(), order.contiguous()


def batched_nms_blocked(boxes, scores, max_out: int, iou_thresh: float, valid=None,
                        block: int = 128):
    """``batched_nms``'s plain version, JAX's blocked fixpoint form (module
    docstring): the path of CPU tensors, and the reference the kernel is
    held to on the card. Same arguments and outputs."""
    m, n_in = scores.shape
    n = -(-n_in // block) * block
    if n != n_in:  # padded entries are dead
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, n - n_in))
        scores = torch.nn.functional.pad(scores, (0, n - n_in), value=NEG_INF)
        if valid is not None:
            valid = torch.nn.functional.pad(valid, (0, n - n_in), value=False)
    sboxes, alive, order = sort_rows(boxes, scores, valid)

    suppressed = torch.zeros((m, n), dtype=torch.bool, device=boxes.device)
    keep = torch.zeros_like(suppressed)
    # i suppresses j only if i comes earlier (higher score)
    tri = torch.ones((block, block), dtype=torch.bool, device=boxes.device).triu(1)
    for start in range(0, n, block):
        stop = start + block
        blk = sboxes[:, start:stop]
        a_mat = ((bbox_overlaps(blk, blk) >= iou_thresh) & tri).float()
        base = alive[:, start:stop] & ~suppressed[:, start:stop]
        k = base
        for _ in range(block):  # converges in the block's suppression depth
            k_new = base & ~(torch.bmm(k[:, None, :].float(), a_mat)[:, 0] > 0)
            if torch.equal(k_new, k):
                break
            k = k_new
        keep[:, start:stop] = k
        if stop < n:
            hits = (k[:, :, None] & (bbox_overlaps(blk, sboxes[:, stop:]) >= iou_thresh)).any(dim=1)
            suppressed[:, stop:] |= hits

    # first max_out kept positions in score order
    top = min(max_out, n)
    pos = torch.arange(n, device=boxes.device)
    sel_key = torch.where(keep, -pos, torch.full_like(pos, -(n + 1)))
    _, sel = topk_stable(sel_key, top)
    sel_ok = torch.gather(keep, 1, sel)
    keep_idx = torch.where(sel_ok, torch.gather(order, 1, sel), torch.zeros_like(sel))
    if top < max_out:
        keep_idx = torch.nn.functional.pad(keep_idx, (0, max_out - top))
        sel_ok = torch.nn.functional.pad(sel_ok, (0, max_out - top))
    return keep_idx, sel_ok


SOFT_NMS_METHODS = ("linear", "gaussian", "hard")


def batched_soft_nms(boxes, scores, max_out: int, sigma: float = 0.5,
                     overlap_thresh: float = 0.3, score_thresh: float = 0.001,
                     method: str = "linear", valid=None):
    """Soft-NMS (reference ``lib/utils_cython/cython_nms.pyx:98-202``) over
    each row of a batch, as JAX's ``ops/nms.soft_nms`` runs it per row.

    Each of `max_out` steps emits every row's current argmax (the first
    maximum, as ``jnp.argmax``) with its possibly decayed score, then decays
    the scores of the boxes overlapping it: ``linear`` by 1 - iou where
    iou > overlap_thresh, ``gaussian`` by exp(-iou²/sigma), ``hard`` to 0
    where iou > overlap_thresh. A score decayed below score_thresh drops
    out. The loop stays on the device: no host sync per step.

    boxes (M, N, 4); scores (M, N); valid (M, N) bool or None. Returns
    (keep_idx (M, max_out) int64, keep_scores (M, max_out), keep_valid
    (M, max_out) bool); empty slots hold 0, 0.0, False.
    """
    if method not in SOFT_NMS_METHODS:
        raise ValueError(f"soft-NMS method must be one of {SOFT_NMS_METHODS}, got {method!r}")
    boxes = boxes.float()
    live = scores.float()
    if valid is not None:
        live = torch.where(valid, live, torch.full_like(live, NEG_INF))
    m = live.shape[0]
    rows = torch.arange(m, device=live.device)
    areas = (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)
    neg_inf = torch.full_like(live, NEG_INF)
    keep_idx, keep_scores, keep_valid = [], [], []
    for _ in range(max_out):
        best = torch.argmax(live, dim=1)
        best_score = live[rows, best]
        best_ok = best_score > NEG_INF
        ious = iou_one_to_many(boxes[rows, best], areas[rows, best], boxes, areas)
        if method == "linear":
            weight = torch.where(ious > overlap_thresh, 1.0 - ious, torch.ones_like(ious))
        elif method == "gaussian":
            weight = torch.exp(-(ious * ious) / sigma)
        else:  # classic NMS as a decay (pyx:180 suppresses at >, not >=)
            weight = torch.where(ious > overlap_thresh, torch.zeros_like(ious),
                                 torch.ones_like(ious))
        # dead entries stay -inf (-inf * 0 would be nan)
        decayed = torch.where(live > NEG_INF, live * weight, neg_inf)
        decayed = torch.where(decayed < score_thresh, neg_inf, decayed)
        live = torch.where(best_ok[:, None], decayed, live)
        live[rows, best] = NEG_INF
        keep_idx.append(torch.where(best_ok, best, torch.zeros_like(best)))
        keep_scores.append(torch.where(best_ok, best_score, torch.zeros_like(best_score)))
        keep_valid.append(best_ok)
    return torch.stack(keep_idx, 1), torch.stack(keep_scores, 1), torch.stack(keep_valid, 1)


def iou_one_to_many(box, box_area, boxes, areas):
    """IoU of one box per row against that row's boxes, +1 convention, with
    JAX's ``ops/boxes.iou_one_to_many`` arithmetic: box (M, 4) and its area
    (M,); boxes (M, N, 4) and their areas (M, N) -> (M, N)."""
    box = box[:, None, :]
    iw = torch.clamp_min(torch.minimum(box[..., 2], boxes[..., 2])
                         - torch.maximum(box[..., 0], boxes[..., 0]) + 1.0, 0.0)
    ih = torch.clamp_min(torch.minimum(box[..., 3], boxes[..., 3])
                         - torch.maximum(box[..., 1], boxes[..., 1]) + 1.0, 0.0)
    inter = iw * ih
    return inter / (box_area[:, None] + areas - inter)


def nms(boxes, scores, max_out: int, iou_thresh: float, valid=None):
    """Single-row NMS: boxes (N, 4), scores (N,) -> ((max_out,), (max_out,))."""
    idx, ok = batched_nms(
        boxes[None], scores[None], max_out, iou_thresh,
        None if valid is None else valid[None],
    )
    return idx[0], ok[0]

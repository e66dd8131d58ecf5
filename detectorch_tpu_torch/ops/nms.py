"""Fixed-shape greedy NMS, batched over a leading axis.

Port of ``detectorch_tpu/ops/nms.py`` (``nms_blocked``): exact Detectron
semantics — suppress at IoU >= thresh with +1 areas, and on equal scores the
HIGHER input index is processed first (the reference's stable reading of
``scores.argsort()[::-1]``). The JAX dispatcher sends N < 192 to an argmax
loop with the same semantics; the blocked form alone serves every N here.

Greedy suppression over the score-sorted order is a DAG recurrence (box j
dies iff a kept earlier box overlaps it). It is evaluated in blocks of 128:
each block resolves its internal dependencies by iterating the antitone map
k -> base & ~(k A) to its unique fixpoint, then suppresses all later boxes
with one vectorised IoU pass. Every row of the batch — (image x level) for
the RPN, (image x class) for postprocessing — advances together, so the
fixpoint test costs one host sync per iteration for the whole batch.

Shapes are static: (M, N) in, (M, max_out) out with a validity mask.
"""

from __future__ import annotations

import torch

from detectorch_tpu_torch.ops.boxes import bbox_overlaps

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
        IoU >= thresh.

    Returns:
      keep_idx: (M, max_out) int64 indices into N (0 for padded slots).
      keep_valid: (M, max_out) bool.
    """
    boxes = boxes.float()
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m, n_in = scores.shape
    n = -(-n_in // block) * block
    if n != n_in:
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, n - n_in))
        scores = torch.nn.functional.pad(scores, (0, n - n_in), value=NEG_INF)

    # descending score with ties toward the HIGHER input index: a stable
    # descending sort of the reversed rows, indices mapped back
    sort_scores, rev = torch.sort(scores.flip(-1), dim=-1, descending=True, stable=True)
    order = (n - 1) - rev
    sboxes = torch.gather(boxes, 1, order[..., None].expand(m, n, 4))
    alive = sort_scores > NEG_INF  # padded/invalid can neither keep nor suppress

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


def nms(boxes, scores, max_out: int, iou_thresh: float, valid=None):
    """Single-row NMS: boxes (N, 4), scores (N,) -> ((max_out,), (max_out,))."""
    idx, ok = batched_nms(
        boxes[None], scores[None], max_out, iou_thresh,
        None if valid is None else valid[None],
    )
    return idx[0], ok[0]

"""Box arithmetic, anchors and greedy NMS in plain PyTorch and numpy.

Detectron's conventions: boxes are (x1, y1, x2, y2) with the "+1" width and
height, regression deltas are clipped at log(1000/16) before the exp, and
NMS suppresses at IoU >= thresh, taking equal scores in the order of the
higher input index first (the stable reading of ``argsort()[::-1]``).
Frozen copies of the port's plain versions, so that a later change to the
program cannot move the yardstick.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)
NEG_INF = float("-inf")


def clip_boxes(boxes, height, width):
    """Clip (..., 4k) boxes to [0, w-1] x [0, h-1]; tensor bounds broadcast
    against ``boxes.shape[:-1]``."""
    shape = boxes.shape
    b = boxes.reshape(shape[:-1] + (-1, 4))
    h1 = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)[..., None] - 1.0
    w1 = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)[..., None] - 1.0
    x1 = torch.minimum(torch.clamp_min(b[..., 0], 0.0), w1)
    y1 = torch.minimum(torch.clamp_min(b[..., 1], 0.0), h1)
    x2 = torch.minimum(torch.clamp_min(b[..., 2], 0.0), w1)
    y2 = torch.minimum(torch.clamp_min(b[..., 3], 0.0), h1)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(shape)


def bbox_transform(boxes, deltas, weights=(1.0, 1.0, 1.0, 1.0)):
    """Decode deltas (..., N, 4k) against boxes (..., N, 4)."""
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    shape = deltas.shape
    d = deltas.reshape(shape[:-1] + (-1, 4))
    wx, wy, ww, wh = weights
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = torch.clamp_max(d[..., 2] / ww, BBOX_XFORM_CLIP)
    dh = torch.clamp_max(d[..., 3] / wh, BBOX_XFORM_CLIP)
    cx = dx * widths[..., None] + ctr_x[..., None]
    cy = dy * heights[..., None] + ctr_y[..., None]
    pw = torch.exp(dw) * widths[..., None]
    ph = torch.exp(dh) * heights[..., None]
    out = torch.stack([cx - 0.5 * pw, cy - 0.5 * ph, cx + 0.5 * pw - 1.0, cy + 0.5 * ph - 1.0],
                      dim=-1)
    return out.reshape(shape)


def boxes_area(boxes):
    return (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)


def bbox_overlaps(boxes, query):
    """Dense IoU, "+1" convention: (..., N, 4) x (..., K, 4) -> (..., N, K)."""
    iw = (torch.minimum(boxes[..., :, None, 2], query[..., None, :, 2])
          - torch.maximum(boxes[..., :, None, 0], query[..., None, :, 0]) + 1.0)
    ih = (torch.minimum(boxes[..., :, None, 3], query[..., None, :, 3])
          - torch.maximum(boxes[..., :, None, 1], query[..., None, :, 1]) + 1.0)
    inter = torch.clamp_min(iw, 0.0) * torch.clamp_min(ih, 0.0)
    union = boxes_area(boxes)[..., :, None] + boxes_area(query)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def filter_boxes_mask(boxes, min_size, scale, im_h, im_w):
    """Proposal min-size and centre-inside mask, (..., N) bool."""
    min_size = min_size * scale
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    x_ctr = boxes[..., 0] + ws / 2.0
    y_ctr = boxes[..., 1] + hs / 2.0
    return (ws >= min_size) & (hs >= min_size) & (x_ctr < im_w) & (y_ctr < im_h)


def generate_anchors(stride: float, sizes: Sequence[float], ratios: Sequence[float]):
    """(A, 4) cell anchors of py-faster-rcnn, ratio-major then size."""
    scales = np.array(sizes, dtype=np.float64) / stride
    base = np.array([1, 1, stride, stride], dtype=np.float64) - 1

    def whctrs(a):
        w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mk(ws, hs, xc, yc):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack((xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
                          xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)))

    w, h, xc, yc = whctrs(base)
    ws = np.round(np.sqrt(w * h / np.array(ratios, dtype=np.float64)))
    hs = np.round(ws * np.array(ratios, dtype=np.float64))
    ratio_anchors = mk(ws, hs, xc, yc)
    out = []
    for a in ratio_anchors:
        w, h, xc, yc = whctrs(a)
        out.append(mk(w * scales, h * scales, xc, yc))
    return np.vstack(out).astype(np.float32)


def shifted_anchors(fh: int, fw: int, stride: float, sizes, ratios, device):
    """(fh*fw*A, 4) anchors on the grid in (H, W, A) order."""
    cell = generate_anchors(stride, sizes, ratios)
    sx, sy = np.meshgrid(np.arange(fw, dtype=np.float32) * stride,
                         np.arange(fh, dtype=np.float32) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    table = (cell[None] + shifts[:, None]).reshape(-1, 4).astype(np.float32)
    return torch.as_tensor(table, device=device)


def topk_stable(x, k: int):
    """The k largest along the last axis, descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def batched_nms(boxes, scores, max_out: int, iou_thresh: float, valid=None, block: int = 128):
    """Greedy NMS of each row: boxes (M, N, 4), scores (M, N), valid (M, N).
    Returns (keep_idx (M, max_out) int64, keep_valid (M, max_out) bool), the
    kept boxes in score order. Each 128-box block resolves its own greedy
    recurrence by a fixpoint, then suppresses every later box."""
    boxes = boxes.float()
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m, n_in = scores.shape
    n = -(-n_in // block) * block
    if n != n_in:
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, n - n_in))
        scores = torch.nn.functional.pad(scores, (0, n - n_in), value=NEG_INF)
    sort_scores, rev = torch.sort(scores.flip(-1), dim=-1, descending=True, stable=True)
    order = (n - 1) - rev
    sboxes = torch.gather(boxes, 1, order[..., None].expand(m, n, 4))
    alive = sort_scores > NEG_INF
    suppressed = torch.zeros((m, n), dtype=torch.bool, device=boxes.device)
    keep = torch.zeros_like(suppressed)
    tri = torch.ones((block, block), dtype=torch.bool, device=boxes.device).triu(1)
    for start in range(0, n, block):
        stop = start + block
        blk = sboxes[:, start:stop]
        a_mat = ((bbox_overlaps(blk, blk) >= iou_thresh) & tri).float()
        base = alive[:, start:stop] & ~suppressed[:, start:stop]
        k = base
        for _ in range(block):
            k_new = base & ~(torch.bmm(k[:, None, :].float(), a_mat)[:, 0] > 0)
            if torch.equal(k_new, k):
                break
            k = k_new
        keep[:, start:stop] = k
        if stop < n:
            hits = (k[:, :, None] & (bbox_overlaps(blk, sboxes[:, stop:]) >= iou_thresh)).any(1)
            suppressed[:, stop:] |= hits
    top = min(max_out, n)
    pos = torch.arange(n, device=boxes.device)
    _, sel = topk_stable(torch.where(keep, -pos, torch.full_like(pos, -(n + 1))), top)
    ok = torch.gather(keep, 1, sel)
    idx = torch.where(ok, torch.gather(order, 1, sel), torch.zeros_like(sel))
    if top < max_out:
        idx = torch.nn.functional.pad(idx, (0, max_out - top))
        ok = torch.nn.functional.pad(ok, (0, max_out - top))
    return idx, ok

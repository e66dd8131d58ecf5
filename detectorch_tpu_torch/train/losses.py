"""Training losses.

Port of ``detectorch_tpu/train/losses.py`` (reference ``lib/model/loss.py``
and the cross-entropy of ``train_fast.py:147``). Each function takes one
image's rows, as JAX's do, and also any leading batch axes: the reductions
run over the trailing row axes only, so (B, R, ...) inputs give (B,)
per-image values — the batch written out where JAX vmaps the per-image loss.
"""

from __future__ import annotations

import torch


def smooth_l1(bbox_pred, bbox_targets, bbox_inside_weights=1.0,
              bbox_outside_weights=1.0, beta: float = 1.0):
    """Detectron smooth-L1 with per-element inside/outside weights: the sum
    over each image's (R, 4K) elements / R."""
    diff = bbox_inside_weights * (bbox_pred - bbox_targets)
    abs_diff = diff.abs()
    flag = (abs_diff < beta).to(bbox_pred.dtype)
    per_elem = flag * 0.5 * diff * diff / beta + (1.0 - flag) * (abs_diff - 0.5 * beta)
    per_elem = bbox_outside_weights * per_elem
    return per_elem.sum(dim=(-2, -1)) / bbox_pred.shape[-2]


def sigmoid_cross_entropy_with_logits(logits, targets):
    """Element-wise sigmoid BCE in fp32: max(x, 0) - x*t + log1p(exp(-|x|))."""
    x = logits.float()
    t = targets.float()
    return torch.clamp_min(x, 0.0) - x * t + torch.log1p(torch.exp(-x.abs()))


def _masked_mean(values, valid):
    if valid is None:
        return values.mean(dim=-1)
    valid = valid.to(values.dtype)
    return (values * valid).sum(dim=-1) / torch.clamp_min(valid.sum(dim=-1), 1.0)


def softmax_cross_entropy(logits, labels, valid=None):
    """Mean cross-entropy over the (valid) rows: logits (..., R, K), int
    labels (..., R) — torch ``F.cross_entropy`` semantics per image."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _masked_mean(nll, valid)


def accuracy(logits, labels, valid=None):
    """Share of (valid) rows whose argmax is the label (reference
    loss.py:22-26)."""
    correct = (torch.argmax(logits, dim=-1) == labels.long()).float()
    return _masked_mean(correct, valid)


def mask_loss(mask_logits, mask_targets, labels, mask_valid):
    """Per-pixel sigmoid cross-entropy on each fg roi's gt-class channel,
    averaged over the valid rois' pixels (upstream Detectron
    SigmoidCrossEntropyLoss semantics).

    mask_logits (..., Rf, M, M, K); mask_targets (..., Rf, M, M) in {0, 1};
    labels (..., Rf) int gt classes; mask_valid (..., Rf) bool."""
    m = mask_logits.shape[-2]
    idx = labels.long()[..., None, None, None].expand(*labels.shape, m, m, 1)
    cls_logits = torch.gather(mask_logits, -1, idx)[..., 0].float()
    per_pix = sigmoid_cross_entropy_with_logits(cls_logits, mask_targets)
    w = mask_valid.float()[..., None, None]
    denom = torch.clamp_min(w.sum(dim=(-3, -2, -1)) * mask_targets.shape[-2]
                            * mask_targets.shape[-1], 1.0)
    return (per_pix * w).sum(dim=(-3, -2, -1)) / denom


def keypoint_loss(kp_logits, kp_labels, kp_valid):
    """Per keypoint, the softmax cross-entropy over the S*S heatmap bins in
    fp32, averaged over the valid (labelled, in-roi, fg) keypoints (upstream
    Detectron's spatial softmax loss for Keypoint R-CNN).

    kp_logits (..., R, S, S, P); kp_labels (..., R, P) flat bin y*S + x;
    kp_valid (..., R, P) bool."""
    s, p = kp_logits.shape[-2], kp_logits.shape[-1]
    flat = kp_logits.movedim(-1, -3).reshape(*kp_logits.shape[:-3], p, s * s)
    logp = torch.log_softmax(flat.float(), dim=-1)
    nll = -torch.gather(logp, -1, kp_labels.long()[..., None])[..., 0]
    w = kp_valid.float()
    return (nll * w).sum(dim=(-2, -1)) / torch.clamp_min(w.sum(dim=(-2, -1)), 1.0)

"""End-to-end Faster / Mask / Keypoint R-CNN training, FPN and C4: RPN and
heads jointly.

Port of ``detectorch_tpu/train/e2e.py`` (upstream Detectron e2e semantics:
anchor targets of ``roi_data/rpn.py``, the RPN losses of ``rpn_heads.py``,
roi sampling from the RPN's own proposals as in ``roi_data/fast_rcnn.py``,
mask targets crop-resized from per-gt rasters, and keypoint heatmap labels
binned from each sampled roi's gt keypoints). The JAX package vmaps a
single-image loss; here every function takes a leading batch axis and the
step runs eagerly on the whole batch: one backbone call, one RPN head call
per level (C4: one level with 15 anchors, its proposals without the FPN
collect), one batched NMS over (image x level), one RoIAlign launch per
branch. Every loss is computed per image, and the step's loss is the mean
of the per-image losses, as JAX's vmapped loss gives.

Randomness. Subsampling keeps the k smallest of uniform priorities, as JAX
does, but the uniforms come from outside: by default ``torch_uniforms``
draws them from a ``torch.Generator`` seeded from (seed, step, image) alone,
so a resumed run draws what an unbroken one draws; a caller may pass its own
(the tests pass the ones JAX's keys give). Per image there are five
vectors (``UNIFORM_KEYS``): anchor positives and anchor negatives (A,), roi
foreground and roi background (P+G,), in [0, 1), and the roi order jitter
(P+G,) in [0, 0.5), with A anchors, P = train_post_nms proposals and G gt
slots.

RoIAlign is differentiable through ``ops.roi_align_fused`` (the CUDA kernels
on CUDA tensors). It is exact for every roi, so JAX's
``frac_rois_overflowed`` metric has no counterpart.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from detectorch_tpu_torch.config import ModelConfig, SamplerConfig, SolverConfig
from detectorch_tpu_torch.models import rpn as rpn_mod
from detectorch_tpu_torch.models.detector import (
    backbone_features,
    c4_anchors,
    c4_proposals,
    fpn_proposals,
    level_anchors,
    rpn_feature_levels,
)
from detectorch_tpu_torch.ops import boxes as box_ops
from detectorch_tpu_torch.train import losses
from detectorch_tpu_torch.train.train_step import (
    check_step_config,
    device_images,
    expand_bbox_targets_device,
    make_init_state,
    roi_heads_loss,
    update,
)

UNIFORM_KEYS = ("anchor_pos", "anchor_neg", "roi_fg", "roi_bg", "roi_order")


def random_keep_mask(mask, k, u, max_keep: Optional[int] = None):
    """Keep at most `k` True entries of each row of `mask`: the k smallest
    of the uniform priorities `u` among the masked entries (Detectron's
    ``npr.choice`` subsampling, fixed-shape).

    mask (..., N) bool; u (..., N) in [0, 1); k an int or a (...) tensor;
    max_keep a static bound on k. JAX selects with ``lax.top_k(-u,
    max_keep)``: ascending u, ties to the lower index. The fp32 bits of a
    non-negative float order as integers, so (bits << 32 | index) is a unique
    int64 key in that order, and ``torch.topk``'s unstated tie order cannot
    change the selection; no full sort of the row is needed."""
    n = mask.shape[-1]
    kmax = n if max_keep is None else int(min(max_keep, n))
    u = torch.where(mask, u.float(), torch.full((), float("inf"), device=u.device))
    key = (u.contiguous().view(torch.int32).to(torch.int64) << 32) \
        | torch.arange(n, device=u.device)
    sel = torch.topk(key, kmax, dim=-1, largest=False, sorted=True).indices
    k = torch.as_tensor(k, device=mask.device)
    keep_sel = torch.arange(kmax, device=mask.device) < k[..., None]
    return mask & torch.zeros_like(mask).scatter(-1, sel, keep_sel.expand(sel.shape))


def _used_gt_columns(gt_valid) -> int:
    """1 + the last gt slot valid in any image of the batch (1 if none): gt
    slots after it hold IoU 0 everywhere and change no max, argmax or tie.
    One small device-to-host copy."""
    cols = np.flatnonzero(gt_valid.any(dim=0).cpu().numpy())
    return int(cols[-1]) + 1 if len(cols) else 1


def rpn_targets(anchors, gt_boxes, gt_valid, im_h, im_w, u_pos, u_neg,
                batch_size: int = 256, fg_fraction: float = 0.5,
                positive_overlap: float = 0.7, negative_overlap: float = 0.3):
    """Anchor labels and regression targets (Detectron roi_data/rpn.py
    ``_get_rpn_blobs``, straddle_thresh 0), per image.

    anchors (A, 4); gt_boxes (B, G, 4) padded, gt_valid (B, G) bool; im_h,
    im_w (B,); u_pos, u_neg (B, A) uniforms. Returns (labels (B, A) int32 in
    {-1, 0, 1}, targets (B, A, 4) fp32):
      - only anchors inside the image take part;
      - positive: IoU >= 0.7 with a gt, and every anchor that ties a gt's
        largest IoU (an exact float equality, as in JAX);
      - negative: largest IoU < 0.3;
      - subsampled to `batch_size` with at most fg_fraction positives;
      - targets: the transform to the argmax gt, weights (1, 1, 1, 1).
    """
    g = _used_gt_columns(gt_valid)
    gt_boxes, gt_valid = gt_boxes[:, :g], gt_valid[:, :g]
    inside = ((anchors[:, 0] >= 0.0) & (anchors[:, 1] >= 0.0)
              & (anchors[:, 2] < im_w[:, None]) & (anchors[:, 3] < im_h[:, None]))
    ov = box_ops.bbox_overlaps(anchors, gt_boxes) * gt_valid.float()[:, None, :]
    ov = torch.where(inside[..., None], ov, torch.zeros((), device=ov.device))
    anchor_max, anchor_argmax = ov.max(dim=-1)  # the first maximum, as jnp.argmax
    gt_max = ov.max(dim=1).values
    ties = ((ov == gt_max[:, None, :]) & (gt_max > 0.0)[:, None, :]).any(dim=-1)
    del ov
    pos = inside & ((anchor_max >= positive_overlap) | ties)
    neg = inside & (anchor_max < negative_overlap) & ~pos

    num_fg = int(fg_fraction * batch_size)
    keep_pos = random_keep_mask(pos, num_fg, u_pos, max_keep=num_fg)
    keep_neg = random_keep_mask(neg, batch_size - keep_pos.sum(dim=-1), u_neg,
                                max_keep=batch_size)
    labels = torch.where(keep_pos, 1, torch.where(keep_neg, 0, -1)).to(torch.int32)
    assigned = torch.gather(gt_boxes, 1, anchor_argmax[..., None].expand(-1, -1, 4))
    return labels, box_ops.bbox_transform_inv(anchors, assigned).float()


def rpn_losses(cls_logits, bbox_pred, labels, targets, batch_size: int = 256,
               beta: float = 1.0 / 9.0):
    """Per-image RPN losses (Detectron rpn_heads): sigmoid CE averaged over
    the sampled anchors; smooth-L1 (beta 1/9) on the positives, summed and
    divided by `batch_size`.

    cls_logits (B, A); bbox_pred (B, A, 4); labels (B, A) {-1, 0, 1};
    targets (B, A, 4). Returns (loss_cls (B,), loss_bbox (B,))."""
    sampled = labels >= 0
    per = losses.sigmoid_cross_entropy_with_logits(cls_logits, (labels == 1).float())
    n = torch.clamp_min(sampled.sum(dim=-1).float(), 1.0)
    loss_cls = torch.where(sampled, per, torch.zeros((), device=per.device)).sum(dim=-1) / n

    d = bbox_pred.float() - targets
    ad = d.abs()
    flag = (ad < beta).float()
    sl1 = flag * 0.5 * d * d / beta + (1.0 - flag) * (ad - 0.5 * beta)
    w = (labels == 1).float()[..., None]
    return loss_cls, (sl1 * w).sum(dim=(-2, -1)) / float(batch_size)


class SampledRois(NamedTuple):
    rois: torch.Tensor     # (B, R, 4) input-image coords, fg rows first
    labels: torch.Tensor   # (B, R) int32 (0 = bg)
    targets: torch.Tensor  # (B, R, 5) compact [cls, tx, ty, tw, th]
    valid: torch.Tensor    # (B, R) bool
    gt_inds: torch.Tensor  # (B, R) int32 argmax-IoU gt (junk on bg/padded rows)


def _take(x, idx):
    """x (B, N, ...) rows by idx (B, R) -> (B, R, ...)."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def sample_rois_device(prop_boxes, prop_valid, gt_boxes, gt_classes, gt_valid,
                       u_fg, u_bg, u_order, cfg: SamplerConfig = SamplerConfig()):
    """Fast R-CNN roi sampling from live RPN proposals (Detectron
    roi_data/fast_rcnn.py ``_sample_rois``; the gt boxes join the candidates
    as ``add_proposals`` adds them in e2e training).

    prop_boxes (B, P, 4), prop_valid (B, P); gt_boxes (B, G, 4), gt_classes
    (B, G), gt_valid (B, G); u_fg, u_bg (B, P+G) in [0, 1), u_order (B, P+G)
    in [0, 0.5). Rows: the kept fg, then the kept bg, then the rest (valid
    False), by a stable argsort of (0 | 1 | 2) + u_order; the host
    sampler's contract, so ``expand_bbox_targets_device`` and the box loss
    take it unchanged. Compact targets use weights (10, 10, 5, 5)."""
    rois = torch.cat([prop_boxes, gt_boxes], dim=1)
    cand = torch.cat([prop_valid, gt_valid], dim=1)
    ov = box_ops.bbox_overlaps(rois, gt_boxes) * gt_valid.float()[:, None, :]
    max_ov, amax = ov.max(dim=-1)
    fg = cand & (max_ov >= cfg.fg_thresh)
    bg = cand & (max_ov < cfg.bg_thresh_hi) & (max_ov >= cfg.bg_thresh_lo)

    r = cfg.rois_per_image
    fg_cap = int(round(cfg.fg_fraction * r))
    keep_fg = random_keep_mask(fg, fg_cap, u_fg, max_keep=fg_cap)
    keep_bg = random_keep_mask(bg, r - keep_fg.sum(dim=-1), u_bg, max_keep=r)
    pri = torch.where(keep_fg, 0.0, torch.where(keep_bg, 1.0, 2.0)) + u_order
    order = torch.argsort(pri, dim=-1, stable=True)[:, :r]

    sel_rois = _take(rois, order)
    sel_fg = torch.gather(keep_fg, 1, order)
    sel_valid = torch.gather(keep_fg | keep_bg, 1, order)
    gt_inds = torch.gather(amax, 1, order)
    sel_labels = torch.where(sel_fg, torch.gather(gt_classes.long(), 1, gt_inds),
                             torch.zeros((), dtype=torch.long, device=order.device)
                             ).to(torch.int32)
    deltas = box_ops.bbox_transform_inv(sel_rois, _take(gt_boxes, gt_inds), (10.0, 10.0, 5.0, 5.0))
    deltas = torch.where(sel_fg[..., None], deltas, torch.zeros((), device=deltas.device))
    compact = torch.cat([sel_labels[..., None].float(), deltas], dim=-1)
    return SampledRois(sel_rois, sel_labels, compact, sel_valid, gt_inds.to(torch.int32))


# Per-gt raster resolution of the device-side mask targets and the
# binarisation threshold, JAX's calibration (train/e2e.py there: 56 / 0.15
# maximise the targets' IoU with polys_to_mask_wrt_box on each sampled roi).
GT_RASTER_RES = 56
GT_RASTER_THRESH = 0.15


def mask_targets_device(gt_rasters, gt_boxes, gt_inds, rois, resolution: int,
                        thresh: float = GT_RASTER_THRESH):
    """Mask targets for rois sampled inside the step: each roi's assigned gt
    raster (the gt's polygons rasterised at GT_RASTER_RES wrt its own box,
    ``train.sampler.polys_to_mask_wrt_box``) bilinearly crop-resized into
    the roi's frame, then thresholded.

    gt_rasters (B, G, Mg, Mg) {0, 1}; gt_boxes (B, G, 4) in the rois' frame;
    gt_inds (B, R) assigned gt per roi; rois (B, R, 4). Returns (B, R, M, M)
    fp32 {0, 1}. The crop is separable: Wv @ raster @ Wuᵀ with two-tap
    weight rows max(0, 1 - |coord - k|), zero outside the gt box. The two
    fp32 products run with TF32 off: the threshold sits in their output."""
    mg = gt_rasters.shape[-1]
    dev = rois.device
    rast = _take(gt_rasters, gt_inds.long()).float()  # (B, R, Mg, Mg)
    gb = _take(gt_boxes, gt_inds.long())
    gw = torch.clamp_min(gb[..., 2] - gb[..., 0], 1.0)
    gh = torch.clamp_min(gb[..., 3] - gb[..., 1], 1.0)
    rw = torch.clamp_min(rois[..., 2] - rois[..., 0], 1.0)
    rh = torch.clamp_min(rois[..., 3] - rois[..., 1], 1.0)
    # a tensor divisor: CUDA divides by a Python number as a multiplication
    # by its reciprocal, an ulp off JAX's quotient
    j = torch.arange(resolution, dtype=torch.float32, device=dev) \
        / torch.full((resolution,), float(resolution), device=dev)
    xs = rois[..., 0:1] + j * rw[..., None]  # (B, R, M)
    ys = rois[..., 1:2] + j * rh[..., None]
    u = (xs - gb[..., 0:1]) * mg / gw[..., None]
    v = (ys - gb[..., 1:2]) * mg / gh[..., None]
    k = torch.arange(mg, dtype=torch.float32, device=dev)
    wu = torch.clamp_min(1.0 - (u[..., None] - k).abs(), 0.0)  # (B, R, M, Mg)
    wv = torch.clamp_min(1.0 - (v[..., None] - k).abs(), 0.0)
    shape = rast.shape[:2]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        vals = torch.bmm(torch.bmm(wv.flatten(0, 1), rast.flatten(0, 1)),
                         wu.flatten(0, 1).transpose(1, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return (vals >= thresh).float().reshape(shape + vals.shape[1:])


def keypoint_labels_device(kps, rois, heatmap_size: int):
    """Heatmap bin labels of rois sampled inside the step: the device twin
    of ``train.sampler.keypoints_to_heatmap_labels`` (upstream Detectron's
    keypoint_utils), in fp32 as JAX's is, where the host's is float64.

    kps (..., R, P, 3) [x, y, v] gt keypoints of each roi's assigned gt, in
    the rois' frame; rois (..., R, 4). Returns (labels (..., R, P) int32
    flat y*S + x, valid (..., R, P) bool). Only a keypoint exactly on the
    right/bottom roi edge clamps into the last bin; one strictly outside
    the roi, or unlabelled (v == 0), is invalid. The scale is computed as
    JAX computes it: the tensor S over the clamped extent (a Python number
    over a tensor is a reciprocal multiply in torch, which puts a keypoint
    on a bin edge one bin off), then (kp - offset) * scale, then floor."""
    s = float(heatmap_size)
    off_x, off_y = rois[..., 0:1], rois[..., 1:2]
    ext_x = torch.clamp_min(rois[..., 2:3] - rois[..., 0:1], 1e-6)
    ext_y = torch.clamp_min(rois[..., 3:4] - rois[..., 1:2], 1e-6)
    scale_x = torch.full_like(ext_x, s) / ext_x
    scale_y = torch.full_like(ext_y, s) / ext_y
    x_edge = kps[..., 0] == rois[..., 2:3]
    y_edge = kps[..., 1] == rois[..., 3:4]
    x = torch.floor((kps[..., 0] - off_x) * scale_x)
    y = torch.floor((kps[..., 1] - off_y) * scale_y)
    last = torch.full((), s - 1.0, device=kps.device)
    x = torch.where(x_edge, last, x)
    y = torch.where(y_edge, last, y)
    valid = (x >= 0) & (y >= 0) & (x < s) & (y < s) & (kps[..., 2] > 0)
    labels = (y * s + x).to(torch.int32)
    return torch.where(valid, labels, torch.zeros_like(labels)), valid


def _image_seed(seed: int, step: int, image: int) -> int:
    return int(np.random.SeedSequence([seed, step, image]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def torch_uniforms(seed: int):
    """The default source of a step's uniforms: for image i of step s, a
    ``torch.Generator`` on the device seeded from (seed, s, i) draws the
    five vectors in ``UNIFORM_KEYS`` order. Returns draw(step, batch_size,
    n_anchors, n_cand, device) -> {key: (B, n)}."""
    def draw(step, batch_size, n_anchors, n_cand, device):
        out = {k: [] for k in UNIFORM_KEYS}
        for i in range(batch_size):
            gen = torch.Generator(device=device)
            gen.manual_seed(_image_seed(seed, step, i))
            for key in UNIFORM_KEYS:
                n = n_anchors if key.startswith("anchor") else n_cand
                out[key].append(torch.rand(n, generator=gen, device=device))
        out = {k: torch.stack(v) for k, v in out.items()}
        out["roi_order"] = out["roi_order"] * 0.5
        return out

    return draw


def e2e_losses(params, cfg: ModelConfig, sampler_cfg: SamplerConfig, images, gt_boxes,
               gt_classes, gt_valid, info, uniforms: Callable, rpn_batch_size: int = 256,
               train_pre_nms: int = 12000, train_post_nms: int = 2000,
               extras: Optional[Dict] = None, roi_align=None,
               anchor_cache: Optional[dict] = None, stage: Optional[Callable] = None):
    """Joint RPN + box (+ mask or keypoint) loss of a batch; the backbone
    runs once.

    images (B, H, W, 3) fp32 padded blobs; gt_boxes (B, G, 4) in input-image
    coords, gt_classes (B, G), gt_valid (B, G); info (B, 3) [resized_h,
    resized_w, im_scale]. uniforms(n_anchors, n_cand) -> {key: (B, n)} (see
    the module docstring). The proposals use the reference's train counts
    (pre 12000 per level, post 2000; C4: one level, no collect) and carry
    no gradient. `roi_align` defaults to the differentiable kernels of
    ``ops.roi_align_fused`` (``train_step.roi_heads_loss``). extras with
    gt_masks (B, G, Mg, Mg) uint8 rasters and gt_mask_valid (B, G) turn on
    the mask branch, over the first round(fg_fraction * R) sampled rows;
    with gt_keypoints (B, G, P, 3) input-scaled [x, y, v], on a preset with
    a keypoint config, the keypoint branch over the same rows.
    stage(name), if given, is called after each stage (the chip smoke test
    synchronises there to time them).

    Returns (total (B,), metrics {name: (B,)} with JAX's keys, SampledRois)."""
    extras = extras or {}
    mark = stage or (lambda name: None)
    cache = {} if anchor_cache is None else anchor_cache
    im_h, im_w, im_scale = info[:, 0], info[:, 1], info[:, 2]
    bsz = images.shape[0]

    feats = backbone_features(params, cfg, images)
    mark("backbone + neck" if cfg.use_fpn else "backbone")
    if cfg.use_fpn:
        rpn_feats, levels = rpn_feature_levels(cfg, feats)
        heads = [rpn_mod.rpn_head(params, f, prefix="_fpn2", return_logits=True)
                 for f in rpn_feats]
    else:
        heads = [rpn_mod.rpn_head(params, feats, prefix="", return_logits=True)]
    mark("rpn head")

    if cfg.use_fpn:
        anchors = torch.cat([level_anchors(cfg, lg.shape[1], lg.shape[2], lvl, lg.device, cache)
                             for (lg, _), lvl in zip(heads, levels)])
    else:
        lg = heads[0][0]
        anchors = c4_anchors(cfg, lg.shape[1], lg.shape[2], lg.device, cache)
    u = uniforms(anchors.shape[0], train_post_nms + gt_boxes.shape[1])
    labels, targets = rpn_targets(anchors, gt_boxes, gt_valid, im_h, im_w,
                                  u["anchor_pos"], u["anchor_neg"], batch_size=rpn_batch_size)
    loss_rpn_cls, loss_rpn_bbox = rpn_losses(
        torch.cat([lg.reshape(bsz, -1) for lg, _ in heads], dim=1),
        torch.cat([dl.reshape(bsz, -1, 4) for _, dl in heads], dim=1),
        labels, targets, batch_size=rpn_batch_size)
    mark("rpn targets + losses")

    with torch.no_grad():
        probs = [torch.sigmoid(lg) for lg, _ in heads]
        deltas = [dl for _, dl in heads]
        if cfg.use_fpn:
            props = fpn_proposals(cfg, probs, deltas, levels, im_h, im_w, im_scale,
                                  train_pre_nms, train_post_nms, cache)
        else:
            props = c4_proposals(cfg, probs[0], deltas[0], im_h, im_w, im_scale,
                                 train_pre_nms, train_post_nms, cache)
    mark("proposals + nms")

    sampled = sample_rois_device(props.boxes, props.valid, gt_boxes, gt_classes, gt_valid,
                                 u["roi_fg"], u["roi_bg"], u["roi_order"], sampler_cfg)
    fg_rows = int(round(sampler_cfg.fg_fraction * sampler_cfg.rois_per_image))
    inds = sampled.gt_inds[:, :fg_rows]
    fg_mask = (sampled.labels[:, :fg_rows] > 0) & sampled.valid[:, :fg_rows]
    mask_targets = mask_valid = kp_labels = kp_valid = None
    if cfg.use_mask and "gt_masks" in extras:
        mask_targets = mask_targets_device(extras["gt_masks"], gt_boxes, inds,
                                           sampled.rois[:, :fg_rows], cfg.mask.resolution)
        mask_valid = fg_mask & torch.gather(extras["gt_mask_valid"], 1, inds.long())
    if cfg.keypoint is not None and "gt_keypoints" in extras:
        kp_labels, kp_valid = keypoint_labels_device(
            _take(extras["gt_keypoints"], inds.long()), sampled.rois[:, :fg_rows],
            cfg.keypoint.heatmap_size)
        kp_valid = kp_valid & fg_mask[..., None]
    targets, inside = expand_bbox_targets_device(sampled.targets, cfg.num_classes)
    mark("sampling + mask targets" if kp_labels is None else "sampling + keypoint labels")

    _, metrics = roi_heads_loss(params, cfg, feats, sampled.rois, sampled.labels, targets,
                                inside, (inside > 0).to(inside.dtype), sampled.valid,
                                mask_targets, mask_valid, roi_align, kp_labels, kp_valid)
    # summed in JAX's order: box, RPN, mask, keypoints
    total = metrics["loss_cls"] + metrics["loss_bbox"] + loss_rpn_cls + loss_rpn_bbox
    for k in ("loss_mask", "loss_kps"):
        if k in metrics:
            total = total + metrics[k]
    metrics.update(loss_rpn_cls=loss_rpn_cls, loss_rpn_bbox=loss_rpn_bbox)
    mark("box + mask heads" if kp_labels is None else "box + keypoint heads")
    return total, metrics, sampled


def make_e2e_train_step(cfg: ModelConfig, solver_cfg: SolverConfig = SolverConfig(),
                        sampler_cfg: SamplerConfig = SamplerConfig(), seed: int = 0,
                        train_pre_nms: int = 12000, train_post_nms: int = 2000,
                        train_mask: bool = False, train_keypoints: bool = False,
                        device_input: bool = False, blob_hw: Tuple[int, int] = (1344, 1344),
                        roi_align_impl: str = "gather", bwd_precision: str = "bf16",
                        uniforms: Optional[Callable] = None):
    """(init_state, make_step) for e2e training, as ``train_step.make_train_step``.

    Batch schema (leading batch axis, tensors on the params' device): image
    (B, H, W, 3) fp32 padded blobs, gt_boxes (B, G, 4) input-scaled,
    gt_classes (B, G), gt_valid (B, G) bool, info (B, 3) [resized_h,
    resized_w, im_scale]. device_input=True replaces image by the uint8
    schema raw (B, RH, RW, 3), tables (B, 4, L), meta (B, 7), resized on the
    device into the blob_hw bucket, and takes info from meta[:, 2:5].
    train_mask adds gt_masks (B, G, Mg, Mg) uint8 and gt_mask_valid (B, G);
    train_keypoints (a preset with a keypoint config) adds gt_keypoints
    (B, G, P, 3) input-scaled [x, y, v].

    uniforms(step, batch_size, n_anchors, n_cand, device) -> {key: (B, n)}
    supplies each step's uniforms; by default ``torch_uniforms(seed)``.
    roi_align_impl and bwd_precision take JAX's names
    (``ops.roi_align_fused.check_roi_align_impl``; the C4 presets take
    'gather', as JAX's do)."""
    if train_keypoints and cfg.keypoint is None:
        raise ValueError("train_keypoints=True needs the keypoint preset")
    check_step_config(cfg, train_mask, roi_align_impl, bwd_precision)
    draw = uniforms or torch_uniforms(seed)
    anchor_cache: Dict = {}

    def make_step(optimizer: torch.optim.SGD):
        def step_fn(state, batch: Dict[str, torch.Tensor]):
            if device_input:
                images, info = device_images(batch, blob_hw), batch["meta"][:, 2:5]
            else:
                images, info = batch["image"], batch["info"]
            extras = ({"gt_masks": batch["gt_masks"], "gt_mask_valid": batch["gt_mask_valid"]}
                      if train_mask else {})
            if train_keypoints:
                extras["gt_keypoints"] = batch["gt_keypoints"]
            bsz, dev = images.shape[0], images.device
            total, metrics, _ = e2e_losses(
                state.params, cfg, sampler_cfg, images, batch["gt_boxes"],
                batch["gt_classes"], batch["gt_valid"], info,
                lambda n_anchors, n_cand: draw(state.step, bsz, n_anchors, n_cand, dev),
                train_pre_nms=train_pre_nms, train_post_nms=train_post_nms, extras=extras,
                anchor_cache=anchor_cache)
            return update(state, optimizer, total, metrics, solver_cfg)

        return step_fn

    return make_init_state(solver_cfg), make_step

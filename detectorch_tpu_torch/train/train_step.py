"""The Fast/Mask R-CNN training step, FPN and C4.

Port of ``detectorch_tpu/train/train_step.py`` (reference ``train_fast.py``:
forward, cross-entropy + smooth-L1, grad clip 35, SGD momentum, per-iter
LR). The JAX package jits one program per step and vmaps a single-image
loss; here the step runs eagerly on the whole batch — one backbone call,
one RoIAlign launch per branch — and keeps JAX's semantics: every loss is
computed per image and the step's loss is the mean of the per-image losses
(``train_step.py:295-300``), not one loss over the flattened batch.

RoIAlign is differentiable through ``ops.roi_align_fused``: the forward and
backward CUDA kernels on CUDA tensors, the plain versions on CPU tensors;
``roi_align_fused`` over the FPN pyramid, ``roi_align_c4_fused`` over the C4
map, whose box and mask heads are res5 (``models.detector.box_head``,
``heads.mask_head('upshare')``). The keypoint branch (a preset with a
keypoint config, FPN or C4) runs over the first Rk rows through the same
differentiable RoIAlign, where JAX's host-sampled step calls its gather
form: the same function. RoIAlign is exact for every roi, so JAX's
``frac_rois_overflowed`` metric (the share of rois that overflow the TPU
kernel's slab) has no counterpart here. End-to-end training
(``train/e2e.py``) builds on ``roi_heads_loss``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from detectorch_tpu_torch.config import ModelConfig, SolverConfig
from detectorch_tpu_torch.data.device_input import device_preprocess
from detectorch_tpu_torch.models import heads as heads_mod
from detectorch_tpu_torch.models.detector import (
    _roi_levels,
    backbone_features,
    box_head,
    compute_dtype,
    roi_features,
)
from detectorch_tpu_torch.ops.cuda.roi_align_kernel import check_precision
from detectorch_tpu_torch.ops.roi_align import check_matmul_precision
from detectorch_tpu_torch.ops.roi_align_fused import (
    check_roi_align_impl,
    roi_align_c4_fused,
    roi_align_fused,
)
from detectorch_tpu_torch.train import losses
from detectorch_tpu_torch.train import solver as solver_mod


class TrainState(NamedTuple):
    step: int
    params: Dict[str, torch.Tensor]   # leaves; trainable ones require grad
    optimizer: torch.optim.SGD


def state_dict(state: TrainState) -> Dict:
    """What a checkpoint holds: step, params and the optimizer's state."""
    return {"step": state.step,
            "params": {k: v.detach() for k, v in state.params.items()},
            "optimizer": state.optimizer.state_dict()}


def load_state_dict(state: TrainState, saved: Dict) -> TrainState:
    """Copy a checkpoint's params and optimizer state into `state`."""
    with torch.no_grad():
        for k, v in state.params.items():
            v.copy_(saved["params"][k])
    state.optimizer.load_state_dict(saved["optimizer"])
    return state._replace(step=int(saved["step"]))


def box_branch_loss(params, cfg: ModelConfig, images, rois, labels, bbox_targets,
                    bbox_inside_weights, bbox_outside_weights, valid,
                    mask_targets=None, mask_valid=None, roi_align=None,
                    kp_labels=None, kp_valid=None):
    """Per-image Fast R-CNN loss of a batch, plus the mask loss when
    mask_targets/mask_valid are given (upstream Detectron mask training) and
    the keypoint loss when cfg has a keypoint config and kp_labels/kp_valid
    are given (Keypoint R-CNN training).

    images (B, H, W, 3) fp32; rois (B, R, 4) scaled xyxy; labels (B, R);
    bbox_targets and both weights (B, R, 4K); valid (B, R) bool;
    mask_targets (B, Rm, M, M) {0, 1} and mask_valid (B, Rm) over the first
    Rm rois of each image, kp_labels (B, Rk, P) heatmap bins y*S + x and
    kp_valid (B, Rk, P) over the first Rk (the sampler puts foreground rows
    first). Returns (total (B,), metrics {name: (B,)}).
    """
    feats = backbone_features(params, cfg, images)
    return roi_heads_loss(params, cfg, feats, rois, labels, bbox_targets,
                          bbox_inside_weights, bbox_outside_weights, valid,
                          mask_targets, mask_valid, roi_align, kp_labels, kp_valid)


def roi_heads_loss(params, cfg: ModelConfig, feats, rois, labels, bbox_targets,
                   bbox_inside_weights, bbox_outside_weights, valid,
                   mask_targets=None, mask_valid=None, roi_align=None,
                   kp_labels=None, kp_valid=None):
    """``box_branch_loss`` on backbone features already computed (the FPN
    pyramid or the C4 map): RoIAlign and the box head over every roi,
    RoIAlign and the keypoint head over the first Rk rois, RoIAlign 14x14
    and the mask head over the first Rm rois; the losses are summed in
    JAX's order. One RoIAlign launch per branch for the whole batch.
    `roi_align` defaults to ``roi_align_fused`` (FPN) or
    ``roi_align_c4_fused`` (C4)."""
    dtype = compute_dtype(cfg)
    roi_align = roi_align or (roi_align_fused if cfg.use_fpn else roi_align_c4_fused)
    levels = _roi_levels(cfg, rois) if cfg.use_fpn else None
    bsz, r = rois.shape[:2]
    roi_feats = roi_features(cfg, feats, rois, cfg.roi_size, roi_align, levels)
    box_feats = box_head(params, cfg, roi_feats.reshape(bsz * r, *roi_feats.shape[2:]))
    del roi_feats
    cls_logits, bbox_pred = heads_mod.box_predictors(params, box_feats, output_prob=False,
                                                     dtype=dtype)
    cls_logits = cls_logits.reshape(bsz, r, -1)
    bbox_pred = bbox_pred.reshape(bsz, r, -1)

    n_valid = torch.clamp_min(valid.float().sum(dim=-1), 1.0)
    loss_cls = losses.softmax_cross_entropy(cls_logits, labels, valid)
    # smooth_l1 divides by the row count; padded rows carry zero weights, so
    # renormalise to the valid count as the reference does
    vmask = valid.float()[..., None]
    loss_bbox = losses.smooth_l1(bbox_pred, bbox_targets, bbox_inside_weights * vmask,
                                 bbox_outside_weights * vmask) * r / n_valid
    acc = losses.accuracy(cls_logits, labels, valid)
    total = loss_cls + loss_bbox
    metrics = {"loss_cls": loss_cls, "loss_bbox": loss_bbox, "accuracy": acc}

    if cfg.keypoint is not None and kp_labels is not None:
        rk, size = kp_labels.shape[1], cfg.keypoint.roi_size
        kp_feats = roi_features(cfg, feats, rois[:, :rk], size, roi_align,
                                None if levels is None else levels[:, :rk])
        heatmaps = heads_mod.keypoint_head(
            params, kp_feats.reshape(bsz * rk, size, size, -1).to(dtype),
            cfg.keypoint.num_convs)
        loss_kps = losses.keypoint_loss(heatmaps.reshape(bsz, rk, *heatmaps.shape[1:]),
                                        kp_labels, kp_valid)
        total = total + loss_kps
        metrics["loss_kps"] = loss_kps

    if cfg.use_mask and mask_targets is not None:
        rm = mask_targets.shape[1]
        msize = cfg.mask.roi_size
        mask_feats = roi_features(cfg, feats, rois[:, :rm], msize, roi_align,
                                  None if levels is None else levels[:, :rm])
        mask_logits = heads_mod.mask_head(
            params, mask_feats.reshape(bsz * rm, msize, msize, -1).to(dtype),
            cfg.mask.head_type, cfg.arch, output_prob=False)
        mask_logits = mask_logits.reshape(bsz, rm, *mask_logits.shape[1:])
        loss_mask = losses.mask_loss(mask_logits, mask_targets, labels[:, :rm], mask_valid)
        total = total + loss_mask
        metrics["loss_mask"] = loss_mask
    return total, metrics


def device_images(batch, blob_hw: Tuple[int, int]):
    """The uint8 schema's images on the device: raw (B, RH, RW, 3), tables
    (B, 4, L) and meta (B, 7) (``data.device_input.pack_tables_meta``)
    resized into the fixed (H, W) = blob_hw bucket -> (B, H, W, 3) fp32."""
    return device_preprocess(batch["raw"], batch["tables"], batch["meta"], *blob_hw)


def expand_bbox_targets_device(compact, num_classes: int):
    """The 4-of-4K expansion on the device: compact (..., R, 5) [cls, tx,
    ty, tw, th] -> (targets (..., R, 4K), inside weights (..., R, 4K))."""
    cls = compact[..., 0].to(torch.int64)
    onehot = ((cls[..., None] == torch.arange(num_classes, device=compact.device))
              & (cls > 0)[..., None]).to(compact.dtype)
    targets = (onehot[..., None] * compact[..., None, 1:5]).reshape(
        *compact.shape[:-1], 4 * num_classes)
    return targets, onehot.repeat_interleave(4, dim=-1)


def make_train_step(cfg: ModelConfig, solver_cfg: SolverConfig = SolverConfig(),
                    device_input: bool = False, blob_hw: Tuple[int, int] = (1344, 1344),
                    train_mask: bool = False, roi_align_impl: str = "gather",
                    bwd_precision: str = "bf16"):
    """Returns (init_state, make_step) for batched Fast R-CNN training.

    init_state(params) -> (TrainState, optimizer): params are port-layout
    tensors on the training device (``checkpoint.convert.params_from_jax``);
    the state holds copies, trainable ones requiring grad.
    make_step(optimizer) -> step_fn(state, batch) -> (state, metrics): one
    forward, backward and SGD update, in place on the state's params.

    batch (host-blob schema), tensors on the params' device: image
    (B, H, W, 3) fp32, rois (B, R, 4), labels (B, R), bbox_targets,
    bbox_inside_weights, bbox_outside_weights (B, R, 4K), valid (B, R);
    with train_mask also mask_targets (B, Rm, M, M) and mask_valid (B, Rm).
    device_input=True (uint8 schema): raw (B, RH, RW, 3) uint8, tables
    (B, 4, L) and meta (B, 7) fp32 in place of image, resized on the device
    into the fixed blob_hw bucket (``device_images``), and
    bbox_targets_compact (B, R, 5) in place of the three (B, R, 4K)
    tensors, expanded on the device (``expand_bbox_targets_device``).
    A preset with a keypoint config takes kp_labels (B, Rk, P) and
    kp_valid (B, Rk, P) in either schema, as JAX's step does.
    metrics: batch means of the per-image losses and accuracy (0-d
    tensors, not synchronised), plus 'loss' and 'lr'.

    roi_align_impl takes JAX's names (``ops.roi_align_fused.ROI_ALIGN_IMPLS``);
    those whose gradient is exact all run the port's one RoIAlign.
    """
    check_step_config(cfg, train_mask, roi_align_impl, bwd_precision)

    def make_step(optimizer: torch.optim.SGD):
        def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
            extra = ({"mask_targets": batch["mask_targets"], "mask_valid": batch["mask_valid"]}
                     if train_mask else {})
            if cfg.keypoint is not None:
                extra.update(kp_labels=batch["kp_labels"], kp_valid=batch["kp_valid"])
            if device_input:
                image = device_images(batch, blob_hw)
                targets, inside = expand_bbox_targets_device(batch["bbox_targets_compact"],
                                                             cfg.num_classes)
                outside = (inside > 0).to(inside.dtype)
            else:
                image, targets = batch["image"], batch["bbox_targets"]
                inside, outside = batch["bbox_inside_weights"], batch["bbox_outside_weights"]
            total, metrics = box_branch_loss(
                state.params, cfg, image, batch["rois"], batch["labels"], targets, inside,
                outside, batch["valid"], **extra)
            return update(state, optimizer, total, metrics, solver_cfg)

        return step_fn

    return make_init_state(solver_cfg), make_step


def check_step_config(cfg: ModelConfig, train_mask: bool, roi_align_impl: str,
                      bwd_precision: str) -> None:
    """Refuse what the port's training steps do not run."""
    if cfg.s2d_stem:
        raise NotImplementedError("the space-to-depth stem is a TPU-only layout")
    if train_mask and not cfg.use_mask:
        raise ValueError("train_mask=True needs a mask preset")
    check_precision(cfg.roi_align_fwd_precision)
    check_roi_align_impl(roi_align_impl, bwd_precision)
    if not cfg.use_fpn:
        check_matmul_precision(cfg.roi_align_precision)
        if roi_align_impl != "gather":
            # JAX asserts it: the Pallas names are the FPN path
            raise ValueError(f"roi_align_impl {roi_align_impl!r} is the FPN path; "
                             "the C4 presets train with 'gather'")


def make_init_state(solver_cfg: SolverConfig):
    """init_state(params) -> (TrainState, optimizer) of a training step."""
    def init_state(params: Dict[str, torch.Tensor]):
        mask = solver_mod.frozen_mask(params)
        leaves = {k: v.detach().clone().requires_grad_(mask[k]) for k, v in params.items()}
        optimizer = solver_mod.make_optimizer(solver_cfg, leaves, mask)
        return TrainState(0, leaves, optimizer), optimizer

    return init_state


def update(state: TrainState, optimizer: torch.optim.SGD, total, metrics,
           solver_cfg: SolverConfig):
    """The step's loss is the mean of the per-image losses `total` (B,):
    its backward and one SGD update; returns (next state, batch-mean
    metrics with 'loss' and 'lr')."""
    loss = total.mean()
    loss.backward()
    solver_mod.apply_update(optimizer, state.step, solver_cfg)
    metrics = {k: v.detach().mean() for k, v in metrics.items()}
    metrics["loss"] = loss.detach()
    metrics["lr"] = solver_mod.get_lr_at_iter(state.step, solver_cfg)
    return TrainState(state.step + 1, state.params, optimizer), metrics

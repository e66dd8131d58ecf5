"""The Fast/Mask R-CNN training step on the FPN path.

Port of ``detectorch_tpu/train/train_step.py`` (reference ``train_fast.py``:
forward, cross-entropy + smooth-L1, grad clip 35, SGD momentum, per-iter
LR). The JAX package jits one program per step and vmaps a single-image
loss; here the step runs eagerly on the whole batch — one backbone call,
one RoIAlign launch per branch — and keeps JAX's semantics: every loss is
computed per image and the step's loss is the mean of the per-image losses
(``train_step.py:295-300``), not one loss over the flattened batch.

RoIAlign is ``ops.roi_align_fused.roi_align_fused``: forward and backward
CUDA kernels on CUDA tensors, the plain versions on CPU tensors. It is exact
for every roi, so JAX's ``frac_rois_overflowed`` metric (the share of rois
that overflow the TPU kernel's slab) has no counterpart here.

Not ported yet, and refused: the C4 path and keypoint training.
End-to-end training (``train/e2e.py``) builds on ``backbone_pyramid`` and
``roi_heads_loss``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from detectorch_tpu_torch.config import ModelConfig, SolverConfig
from detectorch_tpu_torch.data.device_input import device_preprocess
from detectorch_tpu_torch.models import fpn as fpn_mod
from detectorch_tpu_torch.models import heads as heads_mod
from detectorch_tpu_torch.models import resnet as resnet_mod
from detectorch_tpu_torch.models.detector import _fpn_roi_align, _roi_levels, compute_dtype
from detectorch_tpu_torch.ops.cuda.roi_align_kernel import check_precision
from detectorch_tpu_torch.ops.roi_align_fused import check_roi_align_impl, roi_align_fused
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
                    mask_targets=None, mask_valid=None, roi_align=roi_align_fused):
    """Per-image Fast R-CNN loss of a batch, plus the mask loss when
    mask_targets/mask_valid are given (upstream Detectron mask training).

    images (B, H, W, 3) fp32; rois (B, R, 4) scaled xyxy; labels (B, R);
    bbox_targets and both weights (B, R, 4K); valid (B, R) bool;
    mask_targets (B, Rm, M, M) {0, 1} and mask_valid (B, Rm) over the first
    Rm rois of each image (the sampler puts foreground rows first). Returns
    (total (B,), metrics {name: (B,)}).
    """
    _check_trainable(cfg)
    pyramid = backbone_pyramid(params, cfg, images)
    return roi_heads_loss(params, cfg, pyramid, rois, labels, bbox_targets,
                          bbox_inside_weights, bbox_outside_weights, valid,
                          mask_targets, mask_valid, roi_align)


def _check_trainable(cfg: ModelConfig):
    if not cfg.use_fpn:
        raise NotImplementedError("C4 training is not ported yet")
    if cfg.keypoint is not None:
        raise NotImplementedError("keypoint training is not ported yet")


def backbone_pyramid(params, cfg: ModelConfig, images):
    """ResNet body and FPN neck: (B, H, W, 3) fp32 -> NHWC [P2..P5]."""
    feats = resnet_mod.multilevel_body(params, images.to(compute_dtype(cfg)), cfg.arch)
    return fpn_mod.fpn_neck(params, feats, cfg.arch)


def roi_heads_loss(params, cfg: ModelConfig, pyramid, rois, labels, bbox_targets,
                   bbox_inside_weights, bbox_outside_weights, valid,
                   mask_targets=None, mask_valid=None, roi_align=roi_align_fused):
    """``box_branch_loss`` on a pyramid already computed: RoIAlign 7x7 and
    the box head over every roi, RoIAlign 14x14 and the mask head over the
    first Rm rois. One RoIAlign launch per branch for the whole batch."""
    dtype = compute_dtype(cfg)
    levels = _roi_levels(cfg, rois)
    bsz, r = rois.shape[:2]
    roi_feats = _fpn_roi_align(cfg, pyramid, rois, levels, cfg.roi_size, roi_align)
    box_feats = heads_mod.mlp_box_head(params, roi_feats.reshape(bsz * r, *roi_feats.shape[2:]),
                                       dtype)
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

    if cfg.use_mask and mask_targets is not None:
        rm = mask_targets.shape[1]
        msize = cfg.mask.roi_size
        mask_feats = _fpn_roi_align(cfg, pyramid, rois[:, :rm], levels[:, :rm], msize,
                                    roi_align)
        mask_logits = heads_mod.mask_head(
            params, mask_feats.reshape(bsz * rm, msize, msize, -1).to(dtype),
            cfg.mask.head_type, output_prob=False)
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
    _check_trainable(cfg)
    if cfg.s2d_stem:
        raise NotImplementedError("the space-to-depth stem is a TPU-only layout")
    if train_mask and not cfg.use_mask:
        raise ValueError("train_mask=True needs a mask preset")
    check_precision(cfg.roi_align_fwd_precision)
    check_roi_align_impl(roi_align_impl, bwd_precision)


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

"""Detector assembly: images -> padded detections + masks, batched, eager.

Port of the FPN path of ``detectorch_tpu/models/detector.py``
(``make_inference_fn`` with the RPN or with precomputed proposals, and
``make_mask_fn``), with the batch written out where the JAX package vmaps a
per-image program (``parallel/mesh.make_batched_inference_fn``).
Every stage keeps the JAX package's fixed shapes — padded proposal, roi and
detection slots with validity masks — and computes on padded and invalid
slots too, so shapes and kernel launches do not depend on the data.

RoIAlign is exact for every roi (``ops/cuda/roi_align_kernel``), so
``roi_align_exact`` is always True and the JAX engine's exact rerun has no
counterpart here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from detectorch_tpu_torch.config import ModelConfig, TestConfig
from detectorch_tpu_torch.eval.postprocess import Detections, postprocess_detections
from detectorch_tpu_torch.models import fpn as fpn_mod
from detectorch_tpu_torch.models import heads as heads_mod
from detectorch_tpu_torch.models import resnet as resnet_mod
from detectorch_tpu_torch.models import rpn as rpn_mod
from detectorch_tpu_torch.ops import boxes as box_ops
from detectorch_tpu_torch.ops.anchors import shifted_anchors
from detectorch_tpu_torch.ops.cuda.roi_align_kernel import check_precision, roi_align_fwd
from detectorch_tpu_torch.ops.fpn_levels import map_rois_to_fpn_levels
from detectorch_tpu_torch.ops.nms import batched_nms, topk_stable

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


class ModelOutputs(NamedTuple):
    detections: Detections             # (B, K) padded final detections
    masks: Optional[torch.Tensor]      # (B, K, M, M) class-gathered probs
    rois: torch.Tensor                 # (B, N, 4) box-branch rois (scaled)
    roi_valid: torch.Tensor            # (B, N) bool
    cls_scores: torch.Tensor           # (B, N, C)
    bbox_deltas: torch.Tensor          # (B, N, 4C)
    roi_align_exact: torch.Tensor      # (B,) bool, always True here
    keypoints: Optional[torch.Tensor] = None
    all_exact: Optional[torch.Tensor] = None  # (B,) roi_align_exact & nms_exact


def _fpn_roi_align(cfg: ModelConfig, level_feats, rois, levels, size: int,
                   roi_align=roi_align_fwd):
    """RoIAlign of (B, N, 4) rois with (B, N) levels over the NHWC pyramid
    (B, H_l, W_l, C): one launch for the whole batch. Returns
    (B, N, size, size, C) fp32. `roi_align` takes ``roi_align_fwd``'s
    arguments: inference passes that wrapper, training the differentiable
    ``ops.roi_align_fused.roi_align_fused``."""
    bsz, n = rois.shape[:2]
    batch_idx = torch.arange(bsz, dtype=torch.int32, device=rois.device) \
        .repeat_interleave(n)
    out = roi_align(
        [f.contiguous() for f in level_feats],
        rois.reshape(bsz * n, 4).float().contiguous(),
        batch_idx, levels.reshape(bsz * n).to(torch.int32).contiguous(),
        cfg.fpn_spatial_scales, size, size, cfg.roi_sampling_ratio,
    )
    return out.reshape(bsz, n, size, size, -1)


def _roi_levels(cfg: ModelConfig, rois):
    f = cfg.fpn
    return map_rois_to_fpn_levels(
        rois, f.roi_min_level, f.roi_max_level,
        f.roi_canonical_scale, f.roi_canonical_level,
    ) - f.roi_min_level


def rpn_feature_levels(cfg: ModelConfig, pyramid):
    """The RPN's inputs: NHWC [P2..P5] (plus P6, subsampled from P5, when
    cfg.fpn.extra_level) and their FPN levels."""
    fcfg = cfg.fpn
    levels = list(range(fcfg.roi_min_level, fcfg.roi_max_level + 1))
    feats = list(pyramid)
    if fcfg.extra_level:
        feats.append(fpn_mod.subsample2x(pyramid[-1]))
        levels.append(fcfg.roi_max_level + 1)
    return feats, levels


def level_anchors(cfg: ModelConfig, fh: int, fw: int, lvl: int, device, cache: dict):
    """(fh*fw*A, 4) anchors of one FPN level in the NHWC (H, W, A) order:
    stride 2**lvl, one size 32 * 2**(lvl-2); kept in `cache` per shape,
    level and device."""
    key = (fh, fw, lvl, device)
    if key not in cache:
        cache[key] = torch.as_tensor(shifted_anchors(
            int(fh), int(fw), float(2 ** lvl), (32.0 * 2 ** (lvl - 2),),
            tuple(cfg.anchors.aspect_ratios),
        ), device=device)
    return cache[key]


def _fpn_level_proposals(params, cfg: ModelConfig, pyramid, im_h, im_w, im_scale,
                         anchor_cache: Optional[dict] = None):
    """Shared-head RPN on P2..P6 for a batch, then ``fpn_proposals`` at
    cfg.rpn's counts.

    pyramid: NHWC [P2..P5] (B, H_l, W_l, C); im_h, im_w, im_scale: (B,).
    Returns rpn.Proposals with (B, post_nms_top_n, ...) fields."""
    feats, levels = rpn_feature_levels(cfg, pyramid)
    heads = [rpn_mod.rpn_head(params, f, prefix="_fpn2") for f in feats]
    return fpn_proposals(cfg, [h[0] for h in heads], [h[1] for h in heads], levels,
                         im_h, im_w, im_scale, cfg.rpn.pre_nms_top_n,
                         cfg.rpn.post_nms_top_n, anchor_cache)


def fpn_proposals(cfg: ModelConfig, level_probs, level_deltas, levels, im_h, im_w,
                  im_scale, pre: int, post: int, anchor_cache: Optional[dict] = None):
    """Per-level decode of the RPN's outputs, ONE batched NMS over (image x
    level), then the global collect: JAX's ``rpn.generate_proposals`` on
    each level with pre_nms_top_n = min(pre, fh*fw*A) and post_nms_top_n =
    post, then ``collect_proposals(..., post)``.

    level_probs (B, fh, fw, A) objectness probabilities and level_deltas
    (B, fh, fw, 4A), per level in `levels`; im_h, im_w, im_scale: (B,) clip
    and min-size bounds. Returns rpn.Proposals with (B, post, ...) fields."""
    rpn_cfg = cfg.rpn
    cache = {} if anchor_cache is None else anchor_cache
    h_b, w_b, s_b = im_h[:, None], im_w[:, None], im_scale[:, None]
    # every level padded to the widest level's candidate count
    width = max(min(pre, p[0].numel()) for p in level_probs)

    cand_boxes, cand_scores, cand_valid = [], [], []
    for cls_prob, bbox_pred, lvl in zip(level_probs, level_deltas, levels):
        bsz, fh, fw, _ = cls_prob.shape
        anchors = level_anchors(cfg, fh, fw, lvl, cls_prob.device, cache)
        # NHWC flatten == the (H, W, A) anchor order
        scores = cls_prob.reshape(bsz, -1)
        deltas = bbox_pred.reshape(bsz, -1, 4)
        k = min(pre, scores.shape[1])
        top_scores, top_idx = topk_stable(scores, k)
        props = box_ops.bbox_transform(
            anchors[top_idx], torch.gather(deltas, 1, top_idx[..., None].expand(-1, -1, 4)))
        props = box_ops.clip_boxes(props, h_b, w_b)
        ok = box_ops.filter_boxes_mask(props, rpn_cfg.min_size, s_b, h_b, w_b)
        if k < width:
            props = torch.nn.functional.pad(props, (0, 0, 0, width - k))
            top_scores = torch.nn.functional.pad(top_scores, (0, width - k))
            ok = torch.nn.functional.pad(ok, (0, width - k))
        cand_boxes.append(props)
        cand_scores.append(top_scores)
        cand_valid.append(ok)

    n_lvl = len(level_probs)
    boxes = torch.stack(cand_boxes, dim=1)    # (B, L, width, 4)
    scores = torch.stack(cand_scores, dim=1)  # (B, L, width)
    valid = torch.stack(cand_valid, dim=1)
    bsz = boxes.shape[0]
    idx, ok = batched_nms(
        boxes.reshape(bsz * n_lvl, width, 4), scores.reshape(bsz * n_lvl, width),
        post, rpn_cfg.nms_thresh, valid=valid.reshape(bsz * n_lvl, width),
    )
    idx = idx.reshape(bsz, n_lvl, post)
    ok = ok.reshape(bsz, n_lvl, post)
    lvl_boxes = torch.gather(boxes, 2, idx[..., None].expand(-1, -1, -1, 4))
    lvl_scores = torch.where(ok, torch.gather(scores, 2, idx), torch.zeros_like(ok, dtype=scores.dtype))
    lvl_props = [
        rpn_mod.Proposals(boxes=lvl_boxes[:, i], scores=lvl_scores[:, i], valid=ok[:, i])
        for i in range(n_lvl)
    ]
    return rpn_mod.collect_proposals(lvl_props, post)


def blob_bounds(cfg: ModelConfig, image_hw, im_scale, orig_h, orig_w):
    """Per-image proposal clip/filter bounds (B,): the resized image,
    ceiled to the coarsest FPN stride, capped at the padded shape."""
    h, w = image_hw
    im_h = torch.clamp_max(torch.round(orig_h * im_scale), h)
    im_w = torch.clamp_max(torch.round(orig_w * im_scale), w)
    if cfg.use_fpn:
        stride = float(cfg.fpn.coarsest_stride)
        im_h = torch.clamp_max(torch.ceil(im_h / stride) * stride, h)
        im_w = torch.clamp_max(torch.ceil(im_w / stride) * stride, w)
    return im_h, im_w


def box_branch(params, cfg: ModelConfig, test_cfg: TestConfig, level_feats, rois,
               roi_valid, im_scale, orig_h, orig_w, roi_align=roi_align_fwd):
    """RoIAlign 7x7 -> fc6/fc7 -> predictors -> per-class NMS + cap.
    Returns (cls_scores (B,N,C), bbox_deltas (B,N,4C), Detections)."""
    bsz, n = rois.shape[:2]
    dtype = compute_dtype(cfg)
    roi_feats = _fpn_roi_align(cfg, level_feats, rois, _roi_levels(cfg, rois),
                               cfg.roi_size, roi_align)
    box_feats = heads_mod.mlp_box_head(params, roi_feats.reshape(bsz * n, *roi_feats.shape[2:]), dtype)
    cls_scores, bbox_deltas = heads_mod.box_predictors(params, box_feats, dtype=dtype)
    cls_scores = cls_scores.reshape(bsz, n, -1)
    bbox_deltas = bbox_deltas.reshape(bsz, n, -1)
    dets = postprocess_detections(cls_scores, bbox_deltas, rois, roi_valid, im_scale,
                                  orig_h, orig_w, test_cfg, cfg.num_classes)
    return cls_scores, bbox_deltas, dets


def mask_branch(params, cfg: ModelConfig, level_feats, det_boxes, det_classes, im_scale,
                roi_align=roi_align_fwd):
    """RoIAlign 14x14 on the detections (original-image boxes (B, K, 4)) ->
    mask head -> class-gathered (B, K, M, M) fp32 probabilities."""
    bsz, k = det_boxes.shape[:2]
    mask_rois = det_boxes * im_scale[:, None, None]
    msize = cfg.mask.roi_size
    feats = _fpn_roi_align(cfg, level_feats, mask_rois, _roi_levels(cfg, mask_rois),
                           msize, roi_align)
    feats = feats.reshape(bsz * k, msize, msize, -1).to(compute_dtype(cfg))
    probs = heads_mod.mask_head(params, feats, cfg.mask.head_type)
    m = probs.shape[1]
    cls = det_classes.reshape(bsz * k, 1, 1, 1).expand(-1, m, m, 1)
    return torch.gather(probs, 3, cls)[..., 0].reshape(bsz, k, m, m)


def _check_ported(cfg: ModelConfig):
    if not cfg.use_fpn:
        raise NotImplementedError("the C4 path is not ported yet")
    if cfg.keypoint is not None:
        raise NotImplementedError("the keypoint branch is not ported yet")
    if cfg.s2d_stem:
        raise NotImplementedError("the space-to-depth stem is a TPU-only layout")
    check_precision(cfg.roi_align_fwd_precision)


def make_inference_fn(cfg: ModelConfig, test_cfg: TestConfig, roi_align=roi_align_fwd):
    """Build the batched inference program for an FPN `cfg`.

    Returns fn(params, images, im_scale, orig_h, orig_w[, proposals,
    proposals_valid]) -> ModelOutputs:
      params: {blob: tensor} on the images' device (checkpoint.convert);
      images: (B, H, W, 3) fp32 NHWC, RGB, mean-subtracted, resized and
        padded (H, W divisible by 32);
      im_scale, orig_h, orig_w: (B,) fp32 tensors;
      proposals (B, P, 4) scaled-coordinate rois and proposals_valid (B, P)
        bool (all valid if omitted): Fast R-CNN mode (cfg.use_rpn False).
    `roi_align` is the RoIAlign wrapper (kernel on CUDA tensors); pass the
    plain ``ops.roi_align.multilevel_roi_align`` only to compare the two.
    """
    _check_ported(cfg)
    anchor_cache: Dict = {}

    @torch.inference_mode()
    def forward(params, images, im_scale, orig_h, orig_w, proposals=None,
                proposals_valid=None) -> ModelOutputs:
        x = images.to(compute_dtype(cfg))
        feats = resnet_mod.multilevel_body(params, x, cfg.arch)
        pyramid = fpn_mod.fpn_neck(params, feats, cfg.arch)
        if cfg.use_rpn:
            im_h, im_w = blob_bounds(cfg, images.shape[1:3], im_scale, orig_h, orig_w)
            props = _fpn_level_proposals(params, cfg, pyramid, im_h, im_w, im_scale,
                                         anchor_cache)
            rois, roi_valid = props.boxes, props.valid
        else:
            if proposals is None:
                raise ValueError("Fast R-CNN mode needs proposals")
            rois = proposals.float()
            roi_valid = (proposals_valid if proposals_valid is not None
                         else torch.ones(rois.shape[:2], dtype=torch.bool, device=rois.device))
        cls_scores, bbox_deltas, dets = box_branch(
            params, cfg, test_cfg, pyramid, rois, roi_valid, im_scale, orig_h, orig_w,
            roi_align)
        masks = None
        if cfg.use_mask:
            masks = mask_branch(params, cfg, pyramid, dets.boxes, dets.classes, im_scale,
                                roi_align)
        exact = torch.ones(images.shape[0], dtype=torch.bool, device=images.device)
        return ModelOutputs(
            detections=dets, masks=masks, rois=rois, roi_valid=roi_valid,
            cls_scores=cls_scores, bbox_deltas=bbox_deltas, roi_align_exact=exact,
            all_exact=exact & dets.nms_exact,
        )

    return forward


def make_mask_fn(cfg: ModelConfig, roi_align=roi_align_fwd):
    """Mask-only program: final detection boxes -> class-gathered masks.

    fn(params, images, im_scale, orig_h, orig_w, boxes, classes) -> masks
    (B, K, M, M) fp32, with boxes (B, K, 4) in original-image coords and
    classes (B, K). orig_h and orig_w are unused; they keep
    make_inference_fn's argument layout, so the engine wraps both programs
    alike. The JAX version also returns a RoIAlign exactness flag, always
    True here. Recomputes the backbone at the given scale: the multi-scale
    path merges detections from several scales and then runs the mask
    branch once, at the first scale (Detectron's test-aug flow).
    """
    _check_ported(cfg)
    if not cfg.use_mask:
        raise ValueError("make_mask_fn needs a mask preset")

    @torch.inference_mode()
    def forward(params, images, im_scale, orig_h, orig_w, boxes, classes):
        del orig_h, orig_w
        feats = resnet_mod.multilevel_body(params, images.to(compute_dtype(cfg)), cfg.arch)
        pyramid = fpn_mod.fpn_neck(params, feats, cfg.arch)
        return mask_branch(params, cfg, pyramid, boxes.float(), classes.long(), im_scale,
                           roi_align)

    return forward


def init_params(cfg: ModelConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random parameters, numpy, blob for blob equal to the JAX package's
    ``init_params`` (same names, HWIO conv weights, same values); turn them
    into tensors with ``checkpoint.convert.params_from_jax``."""
    p = {}
    p.update(resnet_mod.init_resnet_params(cfg.arch, include_c5=True, seed=seed))
    if cfg.use_fpn:
        p.update(fpn_mod.init_fpn_params(cfg.arch, cfg.fpn.channels, seed=seed + 1))
        if cfg.use_rpn:
            p.update(rpn_mod.init_rpn_params(
                cfg.fpn.channels, len(cfg.anchors.aspect_ratios),
                prefix="_fpn2", seed=seed + 2))
    elif cfg.use_rpn:
        p.update(rpn_mod.init_rpn_params(1024, cfg.anchors.num_anchors, prefix="",
                                         seed=seed + 2))
    p.update(heads_mod.init_box_head_params(
        cfg.box_head, cfg.roi_feature_channels, cfg.num_classes, seed=seed + 3))
    if cfg.use_mask:
        p.update(heads_mod.init_mask_head_params(cfg.mask.head_type, cfg.num_classes,
                                                 seed=seed + 4))
    if cfg.keypoint is not None:
        raise NotImplementedError("keypoint head params are not ported yet")
    return p

"""Detector assembly: images -> padded detections + masks, batched, eager.

Port of ``detectorch_tpu/models/detector.py`` (``make_inference_fn`` with the
RPN or with precomputed proposals, ``make_mask_fn`` and ``make_keypoint_fn``),
for the FPN and the C4 families, with the batch written out where the JAX package vmaps a
per-image program (``parallel/mesh.make_batched_inference_fn``).
Every stage keeps the JAX package's fixed shapes — padded proposal, roi and
detection slots with validity masks — and computes on padded and invalid
slots too, so shapes and kernel launches do not depend on the data.

FPN: ResNet -> FPN neck -> shared RPN head on P2..P6 -> per-level NMS and
collect -> RoIAlign 7x7 over the pyramid -> fc6/fc7; mask head '1up4convs'.
C4: ResNet conv1..res4 -> RPN head on c4 (15 anchors) -> one NMS ->
RoIAlign 14x14 at 1/16 with the adaptive grid -> res5 + mean; mask head
'upshare' (res5 again, then conv5_mask). The keypoint branch (Keypoint
R-CNN, and any preset given a keypoint config) runs RoIAlign 14x14 on the
final detections, routed as the mask branch's, then the keypoint head and
the heatmap decode (``ops.keypoints``). Every RoIAlign form runs the same
CUDA kernel (``ops/cuda/roi_align_kernel``): the pyramid with one level per
roi, C4 with its one level.

RoIAlign is exact for every roi, so ``roi_align_exact`` is always True and
the JAX engine's exact rerun has no counterpart here.
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
from detectorch_tpu_torch.ops import keypoints as kp_ops
from detectorch_tpu_torch.ops.cuda.roi_align_kernel import (
    check_precision,
    roi_align_c4,
    roi_align_fwd,
)
from detectorch_tpu_torch.ops.fpn_levels import map_rois_to_fpn_levels
from detectorch_tpu_torch.ops.roi_align import check_matmul_precision
from detectorch_tpu_torch.utils.profiling import span

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
    keypoints: Optional[torch.Tensor] = None  # (B, K, P, 4) [x, y, logit, prob] fp32
    all_exact: Optional[torch.Tensor] = None  # (B,) roi_align_exact & nms_exact


def _roi_levels(cfg: ModelConfig, rois):
    f = cfg.fpn
    return map_rois_to_fpn_levels(
        rois, f.roi_min_level, f.roi_max_level,
        f.roi_canonical_scale, f.roi_canonical_level,
    ) - f.roi_min_level


def roi_features(cfg: ModelConfig, feats, rois, size: int, roi_align=None, levels=None):
    """RoIAlign of (B, N, 4) rois, one launch for the whole batch:
    (B, N, size, size, C) fp32. FPN: feats is the NHWC pyramid, each roi on
    its level (`levels`, from the rois unless given), and `roi_align` takes
    ``roi_align_fwd``'s arguments (default that wrapper). C4: feats is the
    (B, H, W, 1024) c4 map, at cfg.spatial_scale with cfg's sampling ratio,
    and `roi_align` takes ``roi_align_c4``'s (default that wrapper).
    Training passes the differentiable forms of ``ops.roi_align_fused``."""
    if not cfg.use_fpn:
        return (roi_align or roi_align_c4)(feats, rois, size, size, cfg.spatial_scale,
                                           cfg.roi_sampling_ratio)
    bsz, n = rois.shape[:2]
    if levels is None:
        levels = _roi_levels(cfg, rois)
    batch_idx = torch.arange(bsz, dtype=torch.int32, device=rois.device) \
        .repeat_interleave(n)
    out = (roi_align or roi_align_fwd)(
        [f.contiguous() for f in feats],
        rois.reshape(bsz * n, 4).float().contiguous(),
        batch_idx, levels.reshape(bsz * n).to(torch.int32).contiguous(),
        cfg.fpn_spatial_scales, size, size, cfg.roi_sampling_ratio,
    )
    return out.reshape(bsz, n, size, size, -1)


def backbone_features(params, cfg: ModelConfig, images):
    """(B, H, W, 3) fp32 images -> the NHWC pyramid [P2..P5] (FPN) or the
    (B, H/16, W/16, 1024) c4 map (C4), in the compute dtype."""
    x = images.to(compute_dtype(cfg))
    if cfg.use_fpn:
        return fpn_mod.fpn_neck(params, resnet_mod.multilevel_body(params, x, cfg.arch),
                                cfg.arch)
    return resnet_mod.c4_body(params, x, cfg.arch)


def box_head(params, cfg: ModelConfig, roi_feats, mesh=None):
    """The box head on (R, S, S, C) fp32 roi features -> (R, D) fp32: fc6/fc7
    (FPN, D = 1024; column-parallel over `mesh` where params hold model
    rows), or res5 + mean over the features cast to the compute dtype (C4,
    D = 2048)."""
    dtype = compute_dtype(cfg)
    if cfg.use_fpn:
        return heads_mod.mlp_box_head(params, roi_feats, dtype, mesh)
    return heads_mod.res5_box_head(params, roi_feats.to(dtype), cfg.arch)


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
    stride 2**lvl, one size 32 * 2**(lvl-2); kept in `cache`."""
    return rpn_mod.anchor_table(fh, fw, 2 ** lvl, (32.0 * 2 ** (lvl - 2),),
                                cfg.anchors.aspect_ratios, device, cache)


def c4_anchors(cfg: ModelConfig, fh: int, fw: int, device, cache: dict):
    """(fh*fw*A, 4) anchors of the C4 level: stride 1/spatial_scale, every
    size and aspect ratio of cfg.anchors (A = 15); kept in `cache`."""
    return rpn_mod.anchor_table(fh, fw, 1.0 / cfg.spatial_scale, cfg.anchors.sizes,
                                cfg.anchors.aspect_ratios, device, cache)


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
    level) (``rpn.level_proposals``), then the global collect: JAX's
    ``rpn.generate_proposals`` on each level with pre_nms_top_n = min(pre,
    fh*fw*A) and post_nms_top_n = post, then ``collect_proposals(..., post)``.

    level_probs (B, fh, fw, A) objectness probabilities and level_deltas
    (B, fh, fw, 4A), per level in `levels`; im_h, im_w, im_scale: (B,) clip
    and min-size bounds. Returns rpn.Proposals with (B, post, ...) fields."""
    cache = {} if anchor_cache is None else anchor_cache
    anchors = [level_anchors(cfg, p.shape[1], p.shape[2], lvl, p.device, cache)
               for p, lvl in zip(level_probs, levels)]
    lvl_props = rpn_mod.level_proposals(level_probs, level_deltas, anchors, im_h, im_w,
                                        im_scale, pre, post, cfg.rpn.nms_thresh,
                                        cfg.rpn.min_size)
    return rpn_mod.collect_proposals(lvl_props, post)


def c4_proposals(cfg: ModelConfig, cls_prob, bbox_pred, im_h, im_w, im_scale, pre: int,
                 post: int, anchor_cache: Optional[dict] = None):
    """The C4 RPN's proposals: ``rpn.generate_proposals`` on its one level,
    stride 1/spatial_scale, cfg.anchors' sizes and ratios; no collect."""
    return rpn_mod.generate_proposals(
        cls_prob, bbox_pred, im_h, im_w, im_scale, feat_stride=1.0 / cfg.spatial_scale,
        anchor_sizes=cfg.anchors.sizes, anchor_aspect_ratios=cfg.anchors.aspect_ratios,
        pre_nms_top_n=pre, post_nms_top_n=post, nms_thresh=cfg.rpn.nms_thresh,
        min_size=cfg.rpn.min_size, anchor_cache=anchor_cache)


def rpn_proposals(params, cfg: ModelConfig, feats, im_h, im_w, im_scale,
                  anchor_cache: Optional[dict] = None):
    """The RPN at cfg.rpn's counts over the backbone's feats: FPN's shared
    head on P2..P6 and collect, or C4's head (prefix '') on c4 and one NMS."""
    if cfg.use_fpn:
        return _fpn_level_proposals(params, cfg, feats, im_h, im_w, im_scale, anchor_cache)
    cls_prob, bbox_pred = rpn_mod.rpn_head(params, feats, prefix="")
    return c4_proposals(cfg, cls_prob, bbox_pred, im_h, im_w, im_scale,
                        cfg.rpn.pre_nms_top_n, cfg.rpn.post_nms_top_n, anchor_cache)


def blob_bounds(cfg: ModelConfig, image_hw, im_scale, orig_h, orig_w):
    """Per-image proposal clip/filter bounds (B,): the resized image,
    ceiled to the coarsest FPN stride (FPN only), capped at the padded
    shape."""
    h, w = image_hw
    im_h = torch.clamp_max(torch.round(orig_h * im_scale), h)
    im_w = torch.clamp_max(torch.round(orig_w * im_scale), w)
    if cfg.use_fpn:
        stride = float(cfg.fpn.coarsest_stride)
        im_h = torch.clamp_max(torch.ceil(im_h / stride) * stride, h)
        im_w = torch.clamp_max(torch.ceil(im_w / stride) * stride, w)
    return im_h, im_w


def box_scores(params, cfg: ModelConfig, roi_feats, mesh=None):
    """The box head and predictors on (B, N, S, S, C) roi features:
    (cls_scores (B, N, C) probabilities, bbox_deltas (B, N, 4C))."""
    bsz, n = roi_feats.shape[:2]
    box_feats = box_head(params, cfg, roi_feats.reshape(bsz * n, *roi_feats.shape[2:]), mesh)
    cls_scores, bbox_deltas = heads_mod.box_predictors(params, box_feats,
                                                       dtype=compute_dtype(cfg))
    return cls_scores.reshape(bsz, n, -1), bbox_deltas.reshape(bsz, n, -1)


def box_branch(params, cfg: ModelConfig, test_cfg: TestConfig, feats, rois,
               roi_valid, im_scale, orig_h, orig_w, roi_align=None, mesh=None):
    """RoIAlign (``roi_features``) -> box head -> predictors -> per-class
    NMS + cap. feats: the pyramid (FPN) or c4 (C4). Returns (cls_scores
    (B,N,C), bbox_deltas (B,N,4C), Detections). Spans ``box_head`` and
    ``postprocess`` (``utils.profiling.span``)."""
    with span("box_head"):
        cls_scores, bbox_deltas = box_scores(
            params, cfg, roi_features(cfg, feats, rois, cfg.roi_size, roi_align), mesh)
    with span("postprocess"):
        dets = postprocess_detections(cls_scores, bbox_deltas, rois, roi_valid, im_scale,
                                      orig_h, orig_w, test_cfg, cfg.num_classes)
    return cls_scores, bbox_deltas, dets


def detection_roi_features(cfg: ModelConfig, feats, det_boxes, im_scale, size: int,
                           roi_align=None):
    """RoIAlign (size x size) on the detections (original-image boxes
    (B, K, 4), scaled by im_scale): (B*K, size, size, C) in the compute
    dtype, the mask or keypoint head's input."""
    x = roi_features(cfg, feats, det_boxes * im_scale[:, None, None], size, roi_align)
    return x.reshape(-1, size, size, x.shape[-1]).to(compute_dtype(cfg))


def mask_probs(params, cfg: ModelConfig, x, det_classes):
    """The mask head on ``detection_roi_features`` -> class-gathered
    (B, K, M, M) fp32 probabilities; det_classes (B, K)."""
    bsz, k = det_classes.shape[:2]
    probs = heads_mod.mask_head(params, x, cfg.mask.head_type, cfg.arch)
    m = probs.shape[1]
    cls = det_classes.reshape(bsz * k, 1, 1, 1).expand(-1, m, m, 1)
    return torch.gather(probs, 3, cls)[..., 0].reshape(bsz, k, m, m)


def mask_branch(params, cfg: ModelConfig, feats, det_boxes, det_classes, im_scale,
                roi_align=None):
    """RoIAlign 14x14 on the detections (original-image boxes (B, K, 4)) ->
    mask head -> class-gathered (B, K, M, M) fp32 probabilities."""
    x = detection_roi_features(cfg, feats, det_boxes, im_scale, cfg.mask.roi_size, roi_align)
    return mask_probs(params, cfg, x, det_classes)


def keypoint_heatmaps(params, cfg: ModelConfig, feats, det_boxes, im_scale, roi_align=None):
    """RoIAlign (cfg.keypoint.roi_size) on the detections (original-image
    boxes (B, K, 4)) -> keypoint head: (B*K, S, S, P) fp32 heatmap logits."""
    x = detection_roi_features(cfg, feats, det_boxes, im_scale, cfg.keypoint.roi_size,
                               roi_align)
    return heads_mod.keypoint_head(params, x, cfg.keypoint.num_convs)


def decode_keypoints(heatmaps, det_boxes):
    """(B*K, S, S, P) heatmap logits of the detections (B, K, 4) -> (B, K,
    P, 4) fp32 [x, y, logit, prob] in original-image coords."""
    bsz, k = det_boxes.shape[:2]
    kps = kp_ops.heatmaps_to_keypoints(heatmaps, det_boxes.reshape(bsz * k, 4))
    return kps.reshape(bsz, k, *kps.shape[1:])


def keypoint_branch(params, cfg: ModelConfig, feats, det_boxes, im_scale, roi_align=None):
    """``keypoint_heatmaps`` decoded: (B, K, P, 4) fp32 [x, y, logit, prob]
    in original-image coords."""
    return decode_keypoints(
        keypoint_heatmaps(params, cfg, feats, det_boxes, im_scale, roi_align), det_boxes)


def _check_ported(cfg: ModelConfig):
    if cfg.s2d_stem:
        raise NotImplementedError("the space-to-depth stem is a TPU-only layout")
    check_precision(cfg.roi_align_fwd_precision)
    if not cfg.use_fpn:
        check_matmul_precision(cfg.roi_align_precision)


def make_inference_fn(cfg: ModelConfig, test_cfg: TestConfig, roi_align=None, mesh=None):
    """Build the batched inference program for `cfg` (FPN or C4).

    Returns fn(params, images, im_scale, orig_h, orig_w[, proposals,
    proposals_valid]) -> ModelOutputs:
      params: {blob: tensor} on the images' device (checkpoint.convert);
      images: (B, H, W, 3) fp32 NHWC, RGB, mean-subtracted, resized and
        padded (H, W divisible by 32);
      im_scale, orig_h, orig_w: (B,) fp32 tensors;
      proposals (B, P, 4) scaled-coordinate rois and proposals_valid (B, P)
        bool (all valid if omitted): Fast R-CNN mode (cfg.use_rpn False).
    `roi_align` is the RoIAlign wrapper (the kernel on CUDA tensors; see
    ``roi_features``); pass the plain ``ops.roi_align.multilevel_roi_align``
    (FPN) or ``roi_align_matmul`` (C4) only to compare the two. `mesh`
    (``parallel.mesh``) runs fc6/fc7 column-parallel where params hold its
    model rows; the batch is whatever rows the caller passes.

    Under a ``torch.profiler``, each call is a ``request`` span holding the
    spans ``backbone``, ``proposals`` (RPN mode), ``box_head``,
    ``postprocess`` and ``mask`` (mask presets); ``utils.profiling.span``.
    """
    _check_ported(cfg)
    anchor_cache: Dict = {}

    @torch.inference_mode()
    @span("request")
    def forward(params, images, im_scale, orig_h, orig_w, proposals=None,
                proposals_valid=None) -> ModelOutputs:
        with span("backbone"):
            feats = backbone_features(params, cfg, images)
        if cfg.use_rpn:
            with span("proposals"):
                im_h, im_w = blob_bounds(cfg, images.shape[1:3], im_scale, orig_h, orig_w)
                props = rpn_proposals(params, cfg, feats, im_h, im_w, im_scale,
                                      anchor_cache)
            rois, roi_valid = props.boxes, props.valid
        else:
            if proposals is None:
                raise ValueError("Fast R-CNN mode needs proposals")
            rois = proposals.float()
            roi_valid = (proposals_valid if proposals_valid is not None
                         else torch.ones(rois.shape[:2], dtype=torch.bool, device=rois.device))
        cls_scores, bbox_deltas, dets = box_branch(
            params, cfg, test_cfg, feats, rois, roi_valid, im_scale, orig_h, orig_w,
            roi_align, mesh)
        masks = keypoints = None
        if cfg.use_mask:
            with span("mask"):
                masks = mask_branch(params, cfg, feats, dets.boxes, dets.classes, im_scale,
                                    roi_align)
        if cfg.keypoint is not None:
            keypoints = keypoint_branch(params, cfg, feats, dets.boxes, im_scale, roi_align)
        exact = torch.ones(images.shape[0], dtype=torch.bool, device=images.device)
        return ModelOutputs(
            detections=dets, masks=masks, rois=rois, roi_valid=roi_valid,
            cls_scores=cls_scores, bbox_deltas=bbox_deltas, roi_align_exact=exact,
            keypoints=keypoints, all_exact=exact & dets.nms_exact,
        )

    return forward


def make_mask_fn(cfg: ModelConfig, roi_align=None):
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
        feats = backbone_features(params, cfg, images)
        return mask_branch(params, cfg, feats, boxes.float(), classes.long(), im_scale,
                           roi_align)

    return forward


def make_keypoint_fn(cfg: ModelConfig):
    """Keypoint-only program: final detection boxes -> decoded keypoints.

    fn(params, images, im_scale, orig_h, orig_w, boxes) -> keypoints
    (B, K, P, 4) fp32 [x, y, logit, prob], with boxes (B, K, 4) in
    original-image coords; the role and argument layout of
    ``make_mask_fn`` (the multi-scale path runs the keypoint branch once, on
    the merged detections at the first scale). The JAX version also returns
    a RoIAlign exactness flag, always True here.
    """
    _check_ported(cfg)
    if cfg.keypoint is None:
        raise ValueError("make_keypoint_fn needs a keypoint config")

    @torch.inference_mode()
    def forward(params, images, im_scale, orig_h, orig_w, boxes):
        del orig_h, orig_w
        feats = backbone_features(params, cfg, images)
        return keypoint_branch(params, cfg, feats, boxes.float(), im_scale)

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
        k = cfg.keypoint
        p.update(heads_mod.init_keypoint_head_params(
            k.num_keypoints, k.num_convs, k.conv_dim,
            cfg.fpn.channels if cfg.use_fpn else 1024, seed=seed + 5))
    return p

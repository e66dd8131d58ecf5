"""Typed configuration tree for detectorch_tpu.

The reference has no config system: model hyper-parameters live in
``detector(...)`` constructor kwargs (reference ``lib/model/detector.py:130-151``
plus per-notebook arg sets), training flags in ``train_fast.py:25-68`` argparse,
and many Detectron constants are fossilized as module-level literals
(``lib/utils/boxes.py:73``, ``lib/utils/result_utils.py:97-107``,
``lib/utils/multilevel_rois.py:41``, ``lib/utils/fast_rcnn_sample_rois.py:44-50``).

Here every constant is a named field with the Detectron default, and the seven
README model rows become named presets.

The port's own copy of ``detectorch_tpu/config.py``, held to it by
tests/test_torch_host_copies.py.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# Detectron bbox-delta exp clip: log(1000/16)  (reference lib/utils/boxes.py:73)
BBOX_XFORM_CLIP = 4.135166556742356

# Detectron image pixel means, RGB order after the importer's BGR->RGB conv1
# flip (reference lib/utils/preprocess_sample.py:12 stores them BGR for a BGR
# image pipeline; we work in RGB so the order is reversed — see data/transforms.py).
PIXEL_MEANS_BGR = (102.9801, 115.9465, 122.7717)


@dataclass(frozen=True)
class AnchorConfig:
    """RPN anchor enumeration (reference lib/utils/generate_anchors.py:54-65)."""

    sizes: Tuple[float, ...] = (32, 64, 128, 256, 512)
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    stride: float = 16.0

    @property
    def num_anchors(self) -> int:
        return len(self.sizes) * len(self.aspect_ratios)


@dataclass(frozen=True)
class RPNConfig:
    """Proposal-generation knobs (reference lib/model/generate_proposals.py:13-29)."""

    pre_nms_top_n: int = 6000        # test; 12000 train
    post_nms_top_n: int = 1000       # test; 2000 train
    nms_thresh: float = 0.7
    min_size: float = 0.0


@dataclass(frozen=True)
class FPNConfig:
    """FPN neck + level-routing (reference lib/model/detector.py:12-52,
    lib/utils/multilevel_rois.py:41-53)."""

    channels: int = 256
    # RoI pooling levels P2..P5 (finest..coarsest)
    roi_min_level: int = 2
    roi_max_level: int = 5
    # RPN runs on P2..P6 (extra level = stride-2 subsample of P5,
    # reference detector.py:248-250)
    extra_level: bool = True
    roi_canonical_scale: float = 224.0
    roi_canonical_level: int = 4
    coarsest_stride: int = 32        # image padding multiple (blob.py:39-42)


@dataclass(frozen=True)
class MaskConfig:
    """Mask head (reference lib/model/detector.py:84-112, 216-223)."""

    # 'upshare' (C4: shared layer4 trunk) or '1up4convs' (FPN: 4 conv trunk)
    head_type: str = "upshare"
    resolution: int = 14             # output M×M; 14 for C4, 28 for FPN
    roi_size: int = 14               # RoIAlign output feeding the mask trunk


@dataclass(frozen=True)
class KeypointConfig:
    """Keypoint head (Detectron KRCNN defaults; the reference repo carries
    only the evaluator/dataset halves of keypoint support —
    ``json_dataset_evaluator.py:349-432``, ``json_dataset.py:268-314`` —
    and no model, so the head layout follows upstream Detectron's
    keypoint_rcnn_heads.add_roi_pose_head_v1convX: 8x (3x3 conv 512) +
    4x4/2 deconv + fixed-bilinear 2x upsample -> 56x56 heatmaps."""

    num_keypoints: int = 17
    roi_size: int = 14               # RoIAlign output feeding the trunk
    num_convs: int = 8
    conv_dim: int = 512
    heatmap_size: int = 56           # 14 -> deconv 28 -> bilinear x2 56


@dataclass(frozen=True)
class ModelConfig:
    """One README model row == one ModelConfig (reference notebook cell args)."""

    name: str = "e2e_mask_rcnn_R-50-FPN_2x"
    arch: str = "resnet50"           # 'resnet50' | 'resnet101' | 'resnext101_64x4d'
    use_fpn: bool = True
    use_rpn: bool = True
    use_mask: bool = False
    num_classes: int = 81
    # RoIAlign on the box branch
    roi_size: int = 7                # 14 for C4 (then layer4 strides to 7)
    roi_sampling_ratio: int = 2      # 0 for C4 (=> adaptive ceil(roi/pooled))
    # conv head: 'res5' (layer4+avgpool) or 'mlp' (fc6/fc7 1024)
    box_head: str = "mlp"
    roi_feature_channels: int = 1024
    anchors: AnchorConfig = field(default_factory=AnchorConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    fpn: Optional[FPNConfig] = field(default_factory=FPNConfig)
    mask: Optional[MaskConfig] = None
    keypoint: Optional[KeypointConfig] = None
    # C4 spatial scale (1/16); FPN path derives per-level scales from fpn config
    spatial_scale: float = 0.0625
    # compute dtype for the conv body (fp32 for bit-parity runs, bf16 for speed)
    compute_dtype: str = "bfloat16"
    # matmul precision for the C4 separable RoIAlign: 'highest' = exact fp32
    # (reference-kernel parity; 6-pass bf16 emulation on TPU — measured 55%
    # of C4 inference time), 'high' = bf16_3x (~1e-7 rel error; on TPU it
    # reproduces the CPU-fp32 mirror AP to 1e-4, CLOSER than TPU-'highest'
    # whose fp32 emulation rounds differently — examples/c4_precision_ap.py),
    # 'bf16' = fastest. CPU ignores this knob (always fp32), so the parity
    # harness is unaffected by the default.
    roi_align_precision: str = "high"
    # use the Pallas DMA+MXU kernel for FPN RoIAlign (with an exact gather
    # fallback that only executes when a roi's footprint overflows the slab;
    # see models/detector._fpn_roi_align) — ~2x end-to-end throughput
    use_pallas_roi_align: bool = True
    # matmul precision for the Pallas FPN kernel's forward contractions:
    # 'exact' = fp32 operands / HIGHEST (6-pass bf16 emulation per matmul —
    # bit-exact caffe2 RoIAlign, the tier behind every AP-parity row),
    # 'bf16x3' = fp32 hat weights split into 3 exact bf16 terms against the
    # raw bf16 slab (exact products, fp32 accumulation — ~ulp of 'exact' for
    # bf16 features in half the MXU passes), 'bf16' = single-pass fast bound.
    # Only consulted when use_pallas_roi_align; the C4 path has its own
    # roi_align_precision above.
    roi_align_fwd_precision: str = "exact"
    # evaluate conv1 as a 4x4/1 conv on 2x2 space-to-depth input (the
    # MLPerf-ResNet TPU stem; models/resnet.stem_s2d — identical math,
    # 4x less lane-padded full-resolution activation traffic). Off by
    # default pending the measured win (PERF.md round 5).
    s2d_stem: bool = False

    @property
    def fpn_spatial_scales(self) -> Tuple[float, ...]:
        """RoI-pooling level scales, finest first (0.25, 0.125, 0.0625, 0.03125)."""
        assert self.fpn is not None
        return tuple(
            1.0 / (2 ** lvl)
            for lvl in range(self.fpn.roi_min_level, self.fpn.roi_max_level + 1)
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TestConfig:
    """Inference-time postprocessing (reference lib/utils/result_utils.py:96-168,
    lib/utils/blob.py:57-87)."""

    target_size: int = 800
    max_size: int = 1333
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    # extra padded detection slots for score TIES at the global cap: the
    # reference keeps every detection >= the k-th largest score
    # (result_utils.py:160-166), which can exceed k when scores tie
    detections_tie_slack: int = 8
    bbox_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    soft_nms: bool = False
    soft_nms_sigma: float = 0.5
    soft_nms_method: str = "linear"
    do_bbox_vote: bool = False
    bbox_vote_thresh: float = 0.8
    bbox_vote_method: str = "ID"
    # maximum number of input proposals fed to the box branch (Fast R-CNN
    # precomputed proposals get padded/truncated to this)
    max_proposals: int = 1000
    # pad images exactly like the reference (ceil-to-stride-32 of the
    # resized image) instead of to the static shape buckets: bit-parity
    # edge behaviour for eval at the cost of one compiled program per
    # distinct ceil-32 shape (~10-30 programs over COCO)
    exact_blob_dims: bool = False
    # fuse uint8->blob preprocessing (bilinear resize, mean subtract, pad)
    # into the device program (data/device_input.py): the host uploads raw
    # uint8 pixels, ~25x less input traffic than the fp32 blob. Matches the
    # reference's cv2 path to float32 associativity (~1e-4 abs), not
    # bit-for-bit; AP-parity measured unchanged (PARITY.md)
    device_preprocess: bool = False
    # per-class NMS top-M score prefilter (0 = off): run per-class NMS over
    # only the top-M candidates by score instead of all max_proposals. Exact
    # whenever every class has <= M above-threshold candidates (typical with
    # real weights at score_thresh 0.05); the program flags the rare
    # overflow via Detections.nms_exact and the engine re-runs that image
    # through the full-NMS variant (same design as the Pallas slab rerun).
    nms_topk_prefilter: int = 0
    # keypoint detection score packed into COCO results: 'bbox' (detection
    # score; Detectron KRCNN.KEYPOINT_CONFIDENCE default), 'logit' or
    # 'prob' (mean over keypoints of the heatmap argmax logit / spatial-
    # softmax prob) — reference json_dataset_evaluator.py:377-410
    keypoint_confidence: str = "bbox"
    # dtype the batched engine fetches mask probabilities in. 'bfloat16'
    # (default) halves the dominant device->host payload (the (B,100,28,28)
    # sigmoid tensor); rounding is ±2^-9 near the 0.5 binarisation
    # threshold, AP measured unchanged (PARITY.md). Pin 'float32' for
    # bit-exact mask comparisons against the single-image engine.
    mask_fetch_dtype: str = "bfloat16"

    def replace(self, **kw) -> "TestConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SolverConfig:
    """Training schedule (reference lib/utils/solver.py:1-44, train_fast.py:25-68)."""

    base_lr: float = 0.01
    gamma: float = 0.1
    steps: Tuple[int, ...] = (0, 240000, 320000)
    max_iter: int = 360000
    warmup_iters: int = 500
    warmup_factor: float = 1.0 / 3.0
    momentum: float = 0.9
    weight_decay: float = 0.0001
    clip_grad_norm: float = 35.0
    checkpoint_period: int = 20000


@dataclass(frozen=True)
class SamplerConfig:
    """RoI minibatch sampling (reference lib/utils/fast_rcnn_sample_rois.py:44-50)."""

    rois_per_image: int = 512
    fg_fraction: float = 0.25
    fg_thresh: float = 0.5
    bg_thresh_hi: float = 0.5
    bg_thresh_lo: float = 0.0


def _c4(name: str, arch: str, use_rpn: bool, use_mask: bool) -> ModelConfig:
    return ModelConfig(
        name=name,
        arch=arch,
        use_fpn=False,
        use_rpn=use_rpn,
        use_mask=use_mask,
        roi_size=14,
        roi_sampling_ratio=0,
        box_head="res5",
        roi_feature_channels=2048,
        fpn=None,
        mask=MaskConfig(head_type="upshare", resolution=14, roi_size=14)
        if use_mask
        else None,
    )


def _fpn(name: str, arch: str, use_rpn: bool, use_mask: bool) -> ModelConfig:
    return ModelConfig(
        name=name,
        arch=arch,
        use_fpn=True,
        use_rpn=use_rpn,
        use_mask=use_mask,
        roi_size=7,
        roi_sampling_ratio=2,
        box_head="mlp",
        roi_feature_channels=1024,
        anchors=AnchorConfig(sizes=(32,), aspect_ratios=(0.5, 1.0, 2.0), stride=4.0),
        rpn=RPNConfig(pre_nms_top_n=1000, post_nms_top_n=1000),
        fpn=FPNConfig(),
        mask=MaskConfig(head_type="1up4convs", resolution=28, roi_size=14)
        if use_mask
        else None,
    )


# The seven README rows (reference README.md:24-32).
PRESETS = {
    "fast_rcnn_R-50-C4_2x": _c4("fast_rcnn_R-50-C4_2x", "resnet50", False, False),
    "fast_rcnn_R-50-FPN_2x": _fpn("fast_rcnn_R-50-FPN_2x", "resnet50", False, False),
    "e2e_faster_rcnn_R-50-C4_2x": _c4(
        "e2e_faster_rcnn_R-50-C4_2x", "resnet50", True, False
    ),
    "e2e_faster_rcnn_R-50-FPN_2x": _fpn(
        "e2e_faster_rcnn_R-50-FPN_2x", "resnet50", True, False
    ),
    "e2e_mask_rcnn_R-50-C4_2x": _c4("e2e_mask_rcnn_R-50-C4_2x", "resnet50", True, True),
    "e2e_mask_rcnn_R-50-FPN_2x": _fpn(
        "e2e_mask_rcnn_R-50-FPN_2x", "resnet50", True, True
    ),
    "e2e_mask_rcnn_R-101-FPN_2x": _fpn(
        "e2e_mask_rcnn_R-101-FPN_2x", "resnet101", True, True
    ),
    # The port's own (the JAX package has no ResNeXt): Detectron's
    # 12_2017_baselines/e2e_mask_rcnn_X-101-64x4d-FPN_1x, the R-101-FPN
    # Mask R-CNN on a ResNeXt-101 trunk of 64 groups of width 4.
    "e2e_mask_rcnn_X-101-64x4d-FPN_1x": _fpn(
        "e2e_mask_rcnn_X-101-64x4d-FPN_1x", "resnext101_64x4d", True, True
    ),
    # Keypoint R-CNN (person-only, 17 COCO keypoints). Beyond-parity: the
    # reference ships the keypoint evaluator and dataset metadata but no
    # model; this completes the family with upstream Detectron's
    # e2e_keypoint_rcnn_R-50-FPN layout.
    "e2e_keypoint_rcnn_R-50-FPN_1x": _fpn(
        "e2e_keypoint_rcnn_R-50-FPN_1x", "resnet50", True, False
    ).replace(num_classes=2, keypoint=KeypointConfig()),
}

"""One batched inference request as its stages, each timed by CUDA events.

The counterpart of the JAX repository's stage bisections
(``examples/profile_stages.py``, ``profile_fpn_batched.py``,
``profile_c4.py``) for any RPN preset (FPN Mask/Faster R-CNN, R-101-FPN,
C4, Keypoint R-CNN):

  python -m detectorch_tpu_torch.tools.profile_stages \\
      [--preset e2e_mask_rcnn_R-50-FPN_2x] [--batch 8] [--iters 5] [--device cpu]

The stages are ``models/detector.make_inference_fn``'s request cut at its
own functions, in its order: backbone (+ neck) (``backbone_features``),
RPN + proposals (``blob_bounds``, ``rpn_proposals``), box RoIAlign
(``roi_features``), box head (``box_scores``: fc6/fc7 or C4's res5, and the
predictors), postprocess (``postprocess_detections``), then the mask branch
(``detection_roi_features``, ``mask_probs``) or the keypoint branch
(``detection_roi_features``, the keypoint head, ``decode_keypoints``). A
CUDA event is recorded between stages and the host never waits between
them, so the stages sum to the request as it runs fused; the composed
outputs equal ``make_inference_fn``'s bit for bit on the same inputs (the
tool checks it on every run: a split that computes something else would
be another program).

Inputs are bench's (``RandomState(0)``, ``randn * 50``, 832x1344, scale
1.66, 500x800 originals), weights init_params(seed 0), bf16. One JSON line
per stage (mean ms over --iters requests, the RoIAlign launches inside
it), then one with the fused request's mean ms beside the stages' sum.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, Optional

import torch

from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
from detectorch_tpu_torch.config import PRESETS, TestConfig
from detectorch_tpu_torch.eval.postprocess import postprocess_detections
from detectorch_tpu_torch.models import detector as det
from detectorch_tpu_torch.models.heads import keypoint_head
from detectorch_tpu_torch.tools import measure


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def staged_request(params, cfg, test_cfg, images, im_scale, orig_h, orig_w,
                   stage: Callable[[str], None], anchor_cache: Optional[dict] = None):
    """``make_inference_fn(cfg, test_cfg)``'s request, stage(name) called
    after each stage. Returns (ModelOutputs, the backbone's features)."""
    det._check_ported(cfg)
    if not cfg.use_rpn:
        raise ValueError("profile_stages covers RPN-driven presets only")
    cache = {} if anchor_cache is None else anchor_cache
    with torch.inference_mode():
        feats = det.backbone_features(params, cfg, images)
        stage("backbone + neck" if cfg.use_fpn else "backbone")
        im_h, im_w = det.blob_bounds(cfg, images.shape[1:3], im_scale, orig_h, orig_w)
        props = det.rpn_proposals(params, cfg, feats, im_h, im_w, im_scale, cache)
        rois, roi_valid = props.boxes, props.valid
        stage("rpn + proposals")
        roi_feats = det.roi_features(cfg, feats, rois, cfg.roi_size)
        stage("box roialign")
        cls_scores, bbox_deltas = det.box_scores(params, cfg, roi_feats)
        del roi_feats
        stage("box head")
        dets = postprocess_detections(cls_scores, bbox_deltas, rois, roi_valid, im_scale,
                                      orig_h, orig_w, test_cfg, cfg.num_classes)
        stage("postprocess")
        masks = keypoints = None
        if cfg.use_mask:
            x = det.detection_roi_features(cfg, feats, dets.boxes, im_scale, cfg.mask.roi_size)
            stage("mask roialign")
            masks = det.mask_probs(params, cfg, x, dets.classes)
            stage("mask head")
        if cfg.keypoint is not None:
            x = det.detection_roi_features(cfg, feats, dets.boxes, im_scale,
                                           cfg.keypoint.roi_size)
            stage("keypoint roialign")
            heat = keypoint_head(params, x, cfg.keypoint.num_convs)
            stage("keypoint trunk + deconv + upsample")
            keypoints = det.decode_keypoints(heat, dets.boxes)
            stage("decode")
        exact = torch.ones(images.shape[0], dtype=torch.bool, device=images.device)
        out = det.ModelOutputs(
            detections=dets, masks=masks, rois=rois, roi_valid=roi_valid,
            cls_scores=cls_scores, bbox_deltas=bbox_deltas, roi_align_exact=exact,
            keypoints=keypoints, all_exact=exact & dets.nms_exact)
    return out, feats


def output_differences(a, b) -> List[str]:
    """The fields of two ModelOutputs that are not bitwise equal."""
    fields = {"rois": (a.rois, b.rois), "roi_valid": (a.roi_valid, b.roi_valid),
              "cls_scores": (a.cls_scores, b.cls_scores),
              "bbox_deltas": (a.bbox_deltas, b.bbox_deltas),
              "all_exact": (a.all_exact, b.all_exact),
              "masks": (a.masks, b.masks), "keypoints": (a.keypoints, b.keypoints)}
    for k in a.detections._fields:
        fields[f"detections.{k}"] = (getattr(a.detections, k), getattr(b.detections, k))
    bad = []
    for name, (x, y) in fields.items():
        if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
            bad.append(name)
    return bad


def profile(params, cfg, test_cfg, inputs, device: torch.device, iters: int = 5,
            echo: bool = True) -> Dict:
    """Run the request fused once (the reference) and staged iters + 1
    times (the first warms), then the fused request iters times, all on
    `inputs` (images, im_scale, orig_h, orig_w on `device`). Raises if the
    staged outputs differ from the fused ones. Returns {"stages": [(name,
    mean ms, launches per request)], "request_ms", "stage_sum_ms",
    "outputs", "feats", "fused"}; prints the JSON lines when `echo`."""
    fused_fn = det.make_inference_fn(cfg, test_cfg)
    fused = fused_fn(params, *inputs)
    cache: dict = {}
    runs = []
    for i in range(iters + 1):
        marks = measure.StageMarks(device)
        out, feats = staged_request(params, cfg, test_cfg, *inputs, marks, cache)
        runs.append(marks.stages())
        bad = output_differences(out, fused)
        if bad:
            raise RuntimeError(f"the staged request differs from make_inference_fn's in {bad}")
    runs = runs[1:]
    stages = [(name, sum(r[j][1] for r in runs) / len(runs), runs[-1][j][2])
              for j, (name, _, _) in enumerate(runs[0])]
    request = []
    for _ in range(iters):
        marks = measure.StageMarks(device)
        fused_fn(params, *inputs)
        marks("request")
        request.append(marks.stages()[0][1])
    request_ms = sum(request) / len(request)
    stage_sum = sum(ms for _, ms, _ in stages)
    dev_info = measure.device_info(device)
    bsz = inputs[0].shape[0]
    if echo:
        for name, ms, counts in stages:
            measure.emit({"tool": "profile_stages", "preset": cfg.name, "batch": bsz,
                          "stage": name, "ms": ms, "launches": counts, "device": dev_info})
        measure.emit({"tool": "profile_stages", "preset": cfg.name, "batch": bsz,
                      "request_ms": request_ms, "stage_sum_ms": stage_sum,
                      "images_per_sec": bsz * 1e3 / request_ms, "iters": iters,
                      "outputs_equal_fused": True, "device": dev_info})
    return {"stages": stages, "request_ms": request_ms, "stage_sum_ms": stage_sum,
            "outputs": out, "feats": feats, "fused": fused}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="e2e_mask_rcnn_R-50-FPN_2x")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    from detectorch_tpu_torch.tools import bench

    args = parse_args(argv)
    device = measure.resolve_device(args.device, "profile_stages")
    cfg = PRESETS[args.preset]
    params = params_to_device(params_from_jax(det.init_params(cfg, seed=0)), device)
    inputs = tuple(torch.from_numpy(a).to(device)
                   for a in bench.inference_inputs(args.batch, bench.HEIGHT, bench.WIDTH))
    log(f"profile_stages: {cfg.name} batch={args.batch} {bench.HEIGHT}x{bench.WIDTH} "
        f"on {device}")
    return profile(params, cfg, TestConfig(), inputs, device, args.iters)


if __name__ == "__main__":
    main()

"""What the benchmark takes from the program under test, the port
``detectorch_tpu_torch``: its configuration for a benchmark configuration,
its weights loaded through the users' path for Detectron checkpoints, the
timed entry, and its stage functions for the traced run's split.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from detectorch_tpu_torch.checkpoint.caffe2_import import import_params
from detectorch_tpu_torch.checkpoint.convert import params_to_device
from detectorch_tpu_torch.config import PRESETS, RPNConfig, TestConfig
from detectorch_tpu_torch.eval.postprocess import postprocess_detections
from detectorch_tpu_torch.models import detector as det
from detectorch_tpu_torch.parallel.mesh import make_batched_inference_fn, make_mesh


def port_configs(cfg: dict):
    """(ModelConfig, TestConfig) of the port for a configuration file: the
    preset, with the file's compute dtype and RPN test counts; raises where
    the preset's architecture disagrees with the file."""
    m, t = cfg["model"], cfg["test"]
    mc = PRESETS[cfg["port_preset"]].replace(
        compute_dtype=m["compute_dtype"],
        rpn=RPNConfig(t["rpn_pre_nms_top_n"], t["rpn_post_nms_top_n"], t["rpn_nms_thresh"], 0.0))
    got = {"fpn": mc.use_fpn, "num_classes": mc.num_classes, "box_roi_size": mc.roi_size,
           "roi_sampling_ratio": mc.roi_sampling_ratio, "mask_roi_size": mc.mask.roi_size,
           "mask_resolution": mc.mask.resolution, "anchor_ratios": list(mc.anchors.aspect_ratios)}
    want = dict(m, **t)
    bad = {k: (v, want[k]) for k, v in got.items() if v != want[k]}
    if bad:
        raise ValueError(f"the port's {cfg['port_preset']} differs from the file: {bad}")
    tc = TestConfig(target_size=t["scale"], max_size=t["max_size"],
                    score_thresh=t["score_thresh"], nms_thresh=t["nms_thresh"],
                    detections_per_img=t["detections_per_img"],
                    detections_tie_slack=t["detections_tie_slack"],
                    bbox_reg_weights=tuple(t["bbox_reg_weights"]))
    return mc, tc


def load_params(blobs: Dict[str, torch.Tensor], model_cfg, device) -> Dict[str, torch.Tensor]:
    """The port's params from caffe2 blobs, through ``import_params``."""
    host = {k: v.detach().cpu().numpy() for k, v in blobs.items()}
    return params_to_device(import_params(host, model_cfg), device)


def inference_fn(model_cfg, test_cfg, device):
    """The timed entry: ``make_batched_inference_fn`` on a one-rank mesh."""
    return make_batched_inference_fn(model_cfg, test_cfg, make_mesh(device=device))


STAGES = ("backbone", "proposals", "box_head", "postprocess", "mask")


def staged_request(params, model_cfg, test_cfg, batch, mark):
    """The request cut at the port's public stage functions, ``mark(name)``
    after each; the host never waits between stages."""
    images, im_scale, orig_h, orig_w = batch
    with torch.inference_mode():
        feats = det.backbone_features(params, model_cfg, images)
        mark("backbone")
        im_h, im_w = det.blob_bounds(model_cfg, images.shape[1:3], im_scale, orig_h, orig_w)
        props = det.rpn_proposals(params, model_cfg, feats, im_h, im_w, im_scale)
        mark("proposals")
        cls_scores, bbox_deltas = det.box_scores(
            params, model_cfg, det.roi_features(model_cfg, feats, props.boxes, model_cfg.roi_size))
        mark("box_head")
        dets = postprocess_detections(cls_scores, bbox_deltas, props.boxes, props.valid,
                                      im_scale, orig_h, orig_w, test_cfg, model_cfg.num_classes)
        mark("postprocess")
        det.mask_branch(params, model_cfg, feats, dets.boxes, dets.classes, im_scale)
        mark("mask")


def per_image(out, host) -> List[dict]:
    """One request's outputs, image by image: the rois and class scores as
    the device holds them, the detections and masks as the host got them."""
    boxes, scores, classes, valid, masks = host
    return [{"rois": out.rois[i], "roi_valid": out.roi_valid[i],
             "cls_scores": out.cls_scores[i], "det_boxes": boxes[i], "det_scores": scores[i],
             "det_classes": classes[i], "det_valid": valid[i], "masks": masks[i]}
            for i in range(out.rois.shape[0])]


"""Faults planted under the harness: each returns the timed entry with one
thing broken where the program produces it. ``FAULTS[name](fn,
model_cfg, test_cfg)`` -> the broken entry."""

import dataclasses

import torch

from detectorch_tpu_torch.eval.postprocess import postprocess_detections
from detectorch_tpu_torch.models import detector as det


def _altered(change):
    """The entry with `change(outputs, params, rows, model_cfg, test_cfg)`
    applied to what it returns."""
    def fault(fn, model_cfg, test_cfg):
        def broken(params, *rows):
            return change(fn(params, *rows), params, rows, model_cfg, test_cfg)
        return broken
    return fault


def _invert_one_mask(out, *_):
    masks = out.masks.clone()
    masks[0, 0] = 1.0 - masks[0, 0]
    return out._replace(masks=masks)


def _shift_one_image(out, *_):
    d = out.detections
    return out._replace(detections=d._replace(boxes=d.boxes.clone().index_add_(
        0, torch.tensor([0], device=d.boxes.device), torch.full_like(d.boxes[:1], 40.0))))


def _drop_half_the_proposals(out, *_):
    valid = out.roi_valid.clone()
    valid[:, valid.shape[1] // 2:] = False
    return out._replace(roi_valid=valid)


def _swap_class_scores(out, *_):
    s = out.cls_scores.clone()
    s[0] = s[0].flip(-1)
    return out._replace(cls_scores=s)


def _keep_the_lowest_survivors(out, params, rows, model_cfg, test_cfg):
    """The cap keeps the lowest-scoring detections that survive per-class
    NMS (of up to four times the cap) instead of the highest; the masks
    follow the detections kept."""
    images, im_scale, orig_h, orig_w = rows
    k = test_cfg.detections_per_img
    wide = postprocess_detections(
        out.cls_scores, out.bbox_deltas, out.rois, out.roi_valid, im_scale, orig_h, orig_w,
        dataclasses.replace(test_cfg, detections_per_img=4 * k), model_cfg.num_classes)
    d = out.detections
    low = torch.where(wide.valid, wide.scores, torch.full_like(wide.scores, float("inf")))
    order = torch.argsort(low, dim=1)[:, :k]
    img = torch.arange(order.shape[0], device=order.device)[:, None]

    def take(x):  # the k lowest, then empty slots up to the output's width
        g = x[img, order]
        return torch.cat([g, g.new_zeros((g.shape[0], d.scores.shape[1] - k) + g.shape[2:])], 1)

    valid = take(wide.valid)
    boxes, scores, classes = take(wide.boxes), take(wide.scores), take(wide.classes)
    with torch.inference_mode():
        feats = det.backbone_features(params, model_cfg, images)
        masks = det.mask_branch(params, model_cfg, feats, boxes, classes, im_scale)
    return out._replace(detections=d._replace(boxes=boxes, scores=scores, classes=classes,
                                              valid=valid), masks=masks)


FAULTS = {"invert_one_mask": _altered(_invert_one_mask),
          "shift_one_image": _altered(_shift_one_image),
          "drop_half_the_proposals": _altered(_drop_half_the_proposals),
          "swap_class_scores": _altered(_swap_class_scores),
          "keep_the_lowest_survivors": _altered(_keep_the_lowest_survivors)}

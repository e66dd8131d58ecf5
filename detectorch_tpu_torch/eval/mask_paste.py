"""Mask pasting: M×M roi masks -> full-image RLEs (host side).

Reference ``lib/utils/result_utils.py:170-228`` (segm_results): zero-pad the
M×M mask by 1px (to defeat cv2 border replication — the "top hat" artifact
note at result_utils.py:178-181), expand the reference box by (M+2)/M,
bilinear-resize to the box, binarize at 0.5, paste into an image-size canvas,
RLE-encode. RLE encoding is inherently host-side; everything upstream of this
ran on device.

The port's own copy of ``detectorch_tpu/eval/mask_paste.py``, held to it by
tests/test_torch_host_copies.py.
"""

from __future__ import annotations

from typing import List

import numpy as np

from detectorch_tpu_torch.eval import rle as rle_mod


def expand_boxes_np(boxes: np.ndarray, scale: float) -> np.ndarray:
    """reference boxes.py:245-261 (no +1 convention here)."""
    w_half = (boxes[:, 2] - boxes[:, 0]) * 0.5 * scale
    h_half = (boxes[:, 3] - boxes[:, 1]) * 0.5 * scale
    x_c = (boxes[:, 2] + boxes[:, 0]) * 0.5
    y_c = (boxes[:, 3] + boxes[:, 1]) * 0.5
    out = np.zeros_like(boxes)
    out[:, 0] = x_c - w_half
    out[:, 1] = y_c - h_half
    out[:, 2] = x_c + w_half
    out[:, 3] = y_c + h_half
    return out


def paste_mask(mask: np.ndarray, ref_box_int: np.ndarray, im_h: int, im_w: int,
               thresh: float = 0.5) -> np.ndarray:
    """One (M+2)x(M+2) padded float mask -> (im_h, im_w) uint8."""
    import cv2

    w = max(int(ref_box_int[2] - ref_box_int[0] + 1), 1)
    h = max(int(ref_box_int[3] - ref_box_int[1] + 1), 1)
    resized = cv2.resize(mask, (w, h))
    binary = (resized > thresh).astype(np.uint8)
    im_mask = np.zeros((im_h, im_w), np.uint8)
    x0 = max(ref_box_int[0], 0)
    x1 = min(ref_box_int[2] + 1, im_w)
    y0 = max(ref_box_int[1], 0)
    y1 = min(ref_box_int[3] + 1, im_h)
    if x1 > x0 and y1 > y0:
        im_mask[y0:y1, x0:x1] = binary[
            (y0 - ref_box_int[1]) : (y1 - ref_box_int[1]),
            (x0 - ref_box_int[0]) : (x1 - ref_box_int[0]),
        ]
    return im_mask


def segm_results(
    masks: np.ndarray,
    boxes: np.ndarray,
    im_h: int,
    im_w: int,
    mask_resolution: int,
    thresh: float = 0.5,
    encode: bool = True,
) -> List[object]:
    """masks: (K, M, M) float per-detection class-specific probabilities;
    boxes: (K, 4) xyxy in original-image coords. Returns K RLEs (or uint8
    masks when encode=False), in detection order."""
    import cv2

    m = mask_resolution
    scale = (m + 2.0) / m
    ref_boxes = expand_boxes_np(boxes.astype(np.float64), scale).astype(np.int32)
    padded = np.zeros((m + 2, m + 2), np.float32)
    out = []
    for i in range(len(masks)):
        if not encode:
            padded[1:-1, 1:-1] = masks[i]
            out.append(paste_mask(padded, ref_boxes[i], im_h, im_w, thresh))
            continue
        # RLE path: resize/binarize the box patch, then strip-encode it in
        # place (encode_pasted) — never materialising the full canvas
        padded[1:-1, 1:-1] = masks[i]
        rb = ref_boxes[i]
        w = max(int(rb[2] - rb[0] + 1), 1)
        h = max(int(rb[3] - rb[1] + 1), 1)
        binary = (cv2.resize(padded, (w, h)) > thresh).astype(np.uint8)
        x0 = max(rb[0], 0)
        x1 = min(rb[2] + 1, im_w)
        y0 = max(rb[1], 0)
        y1 = min(rb[3] + 1, im_h)
        if x1 > x0 and y1 > y0:
            crop = binary[(y0 - rb[1]):(y1 - rb[1]), (x0 - rb[0]):(x1 - rb[0])]
            out.append(rle_mod.encode_pasted(crop, int(x0), int(y0), im_h, im_w))
        else:
            out.append(rle_mod.encode_pasted(
                np.zeros((0, 0), np.uint8), 0, 0, im_h, im_w
            ))
    return out

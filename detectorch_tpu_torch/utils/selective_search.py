"""Selective-search proposals for Fast R-CNN demos
(reference lib/utils/selective_search.py:4-36).

The reference uses cv2.ximgproc (opencv-contrib), which is not present in
every build — this module degrades to a dense multi-scale sliding-window
proposal grid when ximgproc is unavailable, so the Fast R-CNN demo path stays
usable. Both return (N, 4) xyxy proposals at original image scale.

The port's own copy of ``detectorch_tpu/utils/selective_search.py``, held to
it by tests/test_torch_utils.py where ximgproc is absent.
"""

from __future__ import annotations

import numpy as np


def has_ximgproc() -> bool:
    import cv2

    return hasattr(cv2, "ximgproc")


def selective_search(im_rgb: np.ndarray, res_size: int = 800, max_boxes: int = 2000):
    """cv2 selective search, image resized to res_size² first and boxes
    rescaled back (reference :12-30)."""
    import cv2

    if not has_ximgproc():
        return _sliding_window_proposals(im_rgb, max_boxes)
    h, w = im_rgb.shape[:2]
    im = cv2.resize(im_rgb, (res_size, res_size))
    ss = cv2.ximgproc.segmentation.createSelectiveSearchSegmentation()
    ss.setBaseImage(im[:, :, ::-1])
    ss.switchToSelectiveSearchFast()
    rects = ss.process()[:max_boxes]  # (x, y, w, h)
    boxes = np.asarray(rects, np.float32)
    boxes[:, 2] += boxes[:, 0]
    boxes[:, 3] += boxes[:, 1]
    boxes[:, [0, 2]] *= w / float(res_size)
    boxes[:, [1, 3]] *= h / float(res_size)
    return boxes


def _sliding_window_proposals(im_rgb: np.ndarray, max_boxes: int = 2000):
    """Dense multi-scale grid fallback: windows of several scales/ratios on a
    coarse stride — crude but keeps demos running without opencv-contrib."""
    h, w = im_rgb.shape[:2]
    boxes = []
    for scale in (0.1, 0.2, 0.35, 0.5, 0.75):
        for ar in (0.5, 1.0, 2.0):
            bw = w * scale * np.sqrt(ar)
            bh = h * scale / np.sqrt(ar)
            if bw < 8 or bh < 8:
                continue
            for y in np.linspace(0, h - bh, max(1, int(2 / scale))):
                for x in np.linspace(0, w - bw, max(1, int(2 / scale))):
                    boxes.append([x, y, x + bw - 1, y + bh - 1])
    boxes = np.asarray(boxes, np.float32)
    return boxes[:max_boxes]

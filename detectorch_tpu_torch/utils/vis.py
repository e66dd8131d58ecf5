"""Detection visualisation (reference lib/utils/vis.py:68-392).

Pure cv2 implementation (`vis_one_image_opencv` style) plus an optional
matplotlib renderer for pdf/jpg export like the reference's `vis_one_image`.

The port's own copy of ``detectorch_tpu/utils/vis.py``, held to it pixel for
pixel by tests/test_torch_utils.py.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from detectorch_tpu_torch.eval import rle as rle_mod
from detectorch_tpu_torch.utils.colormap import colormap
from detectorch_tpu_torch.utils.dummy_datasets import COCO_CLASSES

# Rendering constants and geometry below (the 0.4 mask blend, the white
# contour, the green box/label with gray text at 1.3/0.3 text-height label
# padding) are Detectron's published style and are DERIVED from the
# behavioural spec in reference lib/utils/vis.py:96-136 — they must match
# for output-image parity. The code itself is restructured: the mask blend
# is a vectorised np.where over the whole frame instead of fancy-indexed
# in-place updates, and the label geometry is computed as named pads.
_GRAY = (218, 227, 218)
_GREEN = (18, 127, 15)
_WHITE = (255, 255, 255)


def vis_mask(img, mask, color, alpha: float = 0.4, show_border: bool = True,
             border_thick: int = 1):
    """Alpha-blend a binary mask into the image, white contour around it."""
    import cv2

    inside = (np.asarray(mask) != 0)[..., None]
    blended = np.where(
        inside,
        img.astype(np.float32) * (1.0 - alpha)
        + np.asarray(color, np.float32) * alpha,
        img.astype(np.float32),
    )
    out = blended.astype(np.uint8)
    if show_border:
        contours = cv2.findContours(
            np.ascontiguousarray(mask), cv2.RETR_CCOMP, cv2.CHAIN_APPROX_NONE
        )[-2]
        cv2.drawContours(out, contours, -1, _WHITE, border_thick, cv2.LINE_AA)
    return out


def vis_bbox(img, bbox, color=_GREEN, thick: int = 1):
    import cv2

    x1, y1, x2, y2 = (int(v) for v in bbox)
    cv2.rectangle(img, (x1, y1), (x2, y2), color, thickness=thick)
    return img


def vis_class(img, pos, class_str, font_scale: float = 0.35):
    """Class label: filled green backdrop sized to the text, gray text."""
    import cv2

    x0, y0 = int(pos[0]), int(pos[1])
    font = cv2.FONT_HERSHEY_SIMPLEX
    (text_w, text_h), _ = cv2.getTextSize(class_str, font, font_scale, 1)
    pad_top = int(1.3 * text_h)   # backdrop extends this far above the anchor
    pad_base = int(0.3 * text_h)  # text baseline sits this far above it
    cv2.rectangle(img, (x0, y0 - pad_top), (x0 + text_w, y0), _GREEN, -1)
    cv2.putText(img, class_str, (x0, y0 - pad_base), font, font_scale,
                _GRAY, lineType=cv2.LINE_AA)
    return img


# COCO person keypoint order (data/synth.COCO_PERSON_KEYPOINTS) and the
# reference's kp_connections graph (vis.py:47-64, name-based)
_KP_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]

_KP_LINES = [
    ("left_eye", "right_eye"), ("left_eye", "nose"), ("right_eye", "nose"),
    ("right_eye", "right_ear"), ("left_eye", "left_ear"),
    ("right_shoulder", "right_elbow"), ("right_elbow", "right_wrist"),
    ("left_shoulder", "left_elbow"), ("left_elbow", "left_wrist"),
    ("right_hip", "right_knee"), ("right_knee", "right_ankle"),
    ("left_hip", "left_knee"), ("left_knee", "left_ankle"),
    ("right_shoulder", "left_shoulder"), ("right_hip", "left_hip"),
]


def _rainbow_bgr_colors(n: int):
    """n colors along matplotlib's 'rainbow' map as BGR uint8 tuples —
    computed directly (purple->red linear hue sweep: r=t ramp, g=sin arc,
    b=cos falloff) so the cv2 renderer needs no matplotlib import."""
    t = np.linspace(0.0, 1.0, n)
    r = t
    g = np.sin(t * np.pi)
    b = np.cos(t * np.pi / 2)
    return [
        (float(bb * 255), float(gg * 255), float(rr * 255))
        for rr, gg, bb in zip(r, g, b)
    ]


def vis_keypoints(img, kps, kp_thresh: float = 2.0, alpha: float = 0.7,
                  kp_names: Sequence[str] = _KP_NAMES):
    """Draw one instance's keypoint skeleton (reference vis.py:140-196,
    carried there as commented-out code — re-enabled here). kps is (P, 4)
    keypoint-major [x, y, logit, prob] (ops/keypoints.py payload; the
    reference's is the (4, P) transpose); kp_thresh gates on the logit."""
    import cv2

    kps = np.asarray(kps, np.float64)
    lines = [
        (kp_names.index(a), kp_names.index(b)) for a, b in _KP_LINES
        if a in kp_names and b in kp_names
    ]
    colors = _rainbow_bgr_colors(len(lines) + 2)
    kp_mask = np.copy(img)

    def pt(xy):
        return int(round(xy[0])), int(round(xy[1]))

    # mid-shoulder -> nose and mid-shoulder -> mid-hip trunk lines first
    name_idx = {n: i for i, n in enumerate(kp_names)}
    if all(n in name_idx for n in
           ("left_shoulder", "right_shoulder", "left_hip", "right_hip",
            "nose")):
        ls, rs = name_idx["left_shoulder"], name_idx["right_shoulder"]
        lh, rh = name_idx["left_hip"], name_idx["right_hip"]
        nose = name_idx["nose"]
        mid_shoulder = (kps[ls, :2] + kps[rs, :2]) / 2.0
        sc_mid_shoulder = min(kps[ls, 2], kps[rs, 2])
        mid_hip = (kps[lh, :2] + kps[rh, :2]) / 2.0
        sc_mid_hip = min(kps[lh, 2], kps[rh, 2])
        if sc_mid_shoulder > kp_thresh and kps[nose, 2] > kp_thresh:
            cv2.line(kp_mask, pt(mid_shoulder), pt(kps[nose, :2]),
                     color=colors[len(lines)], thickness=2,
                     lineType=cv2.LINE_AA)
        if sc_mid_shoulder > kp_thresh and sc_mid_hip > kp_thresh:
            cv2.line(kp_mask, pt(mid_shoulder), pt(mid_hip),
                     color=colors[len(lines) + 1], thickness=2,
                     lineType=cv2.LINE_AA)

    for l, (i1, i2) in enumerate(lines):
        if kps[i1, 2] > kp_thresh and kps[i2, 2] > kp_thresh:
            cv2.line(kp_mask, pt(kps[i1, :2]), pt(kps[i2, :2]),
                     color=colors[l], thickness=2, lineType=cv2.LINE_AA)
        if kps[i1, 2] > kp_thresh:
            cv2.circle(kp_mask, pt(kps[i1, :2]), radius=3, color=colors[l],
                       thickness=-1, lineType=cv2.LINE_AA)
        if kps[i2, 2] > kp_thresh:
            cv2.circle(kp_mask, pt(kps[i2, :2]), radius=3, color=colors[l],
                       thickness=-1, lineType=cv2.LINE_AA)

    return cv2.addWeighted(img, 1.0 - alpha, kp_mask, alpha, 0)


def vis_one_image_opencv(
    img_rgb: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: Sequence[int],
    rles: Optional[List] = None,
    keypoints: Optional[np.ndarray] = None,
    thresh: float = 0.7,
    kp_thresh: float = 2.0,
    class_names: Sequence[str] = COCO_CLASSES,
    show_class: bool = True,
):
    """Draw detections; returns an RGB uint8 image. `keypoints` is
    (N, P, 4) decoded keypoints (engine result dict key 'keypoints')."""
    img = img_rgb.copy()
    if len(boxes) == 0:
        return img
    cmap = colormap(rgb=True)
    order = np.argsort(-np.asarray(scores))
    mask_color_id = 0
    for i in order:
        if scores[i] < thresh:
            continue
        img = vis_bbox(img, boxes[i])
        if show_class:
            name = class_names[int(classes[i])] if int(classes[i]) < len(class_names) else str(classes[i])
            img = vis_class(img, (boxes[i][0], boxes[i][1] - 2), f"{name} {scores[i]:.2f}")
        if rles is not None and i < len(rles):
            color = cmap[mask_color_id % len(cmap)]
            mask_color_id += 1
            img = vis_mask(img, rle_mod.decode(rles[i]), color)
        if keypoints is not None and i < len(keypoints):
            img = vis_keypoints(img, keypoints[i], kp_thresh)
    return img


def vis_one_image(
    img_rgb,
    boxes,
    scores,
    classes,
    rles=None,
    keypoints=None,
    thresh: float = 0.7,
    output_path: Optional[str] = None,
    class_names: Sequence[str] = COCO_CLASSES,
):
    """Render and optionally save (reference vis_one_image writes
    demo/output/sample.jpg)."""
    out = vis_one_image_opencv(
        img_rgb, boxes, scores, classes, rles, keypoints,
        thresh=thresh, class_names=class_names,
    )
    if output_path:
        import cv2

        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        cv2.imwrite(output_path, out[:, :, ::-1])
    return out


def vis_one_image_matplotlib(
    img_rgb,
    boxes,
    scores,
    classes,
    rles=None,
    keypoints=None,
    thresh: float = 0.7,
    kp_thresh: float = 2.0,
    output_dir: Optional[str] = None,
    im_name: str = "image",
    ext: str = "pdf",
    dpi: int = 200,
    box_alpha: float = 0.8,
    show_class: bool = True,
    class_names: Sequence[str] = COCO_CLASSES,
):
    """Matplotlib renderer with polygonised masks, saving pdf/jpg/png —
    behavioural parity with the reference's `vis_one_image`
    (lib/utils/vis.py:251-392): frameless figure sized im/dpi, detections
    drawn largest-to-smallest to reduce occlusion, thin green box
    rectangles, white serif class text on a green patch, masks as filled
    matplotlib Polygons from cv2 contours with the colormap color
    lightened by 0.4 and white edges. Saved as
    `<output_dir>/<basename(im_name)>.<ext>`; returns the saved path (or
    None if nothing exceeds `thresh` — the reference returns without
    writing in that case too, vis.py:263-264).
    """
    import cv2
    import matplotlib

    matplotlib.use("Agg")  # headless backend; no display in this stack
    import matplotlib.pyplot as plt
    from matplotlib.patches import Polygon

    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    scores = np.asarray(scores, np.float64).reshape(-1)
    if len(boxes) == 0 or (len(scores) and scores.max() < thresh):
        return None

    masks = None
    if rles is not None and len(rles):
        masks = np.stack([rle_mod.decode(r) for r in rles], axis=2)
    color_list = colormap(rgb=True) / 255.0

    if keypoints is not None:
        # skeletons share the cv2 raster path (one source of truth for the
        # skeleton semantics; the reference's matplotlib keypoint code is
        # commented out, vis.py:198-248) — blend them into the backdrop
        # before the vector overlays. Float images in [0, 1] (which imshow
        # renders fine on the non-keypoint path) are scaled to [0, 255]
        # before the uint8 cast so both paths accept the same dtypes.
        img_rgb = np.asarray(img_rgb)
        if np.issubdtype(img_rgb.dtype, np.floating) and img_rgb.max() <= 1.0:
            img_rgb = img_rgb * 255.0
        img_rgb = img_rgb.astype(np.uint8, copy=True)
        for i in range(len(boxes)):
            if scores[i] >= thresh and i < len(keypoints):
                img_rgb = vis_keypoints(img_rgb, keypoints[i], kp_thresh)

    fig = plt.figure(frameon=False)
    fig.set_size_inches(img_rgb.shape[1] / dpi, img_rgb.shape[0] / dpi)
    ax = plt.Axes(fig, [0.0, 0.0, 1.0, 1.0])
    ax.axis("off")
    fig.add_axes(ax)
    ax.imshow(img_rgb)

    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    order = np.argsort(-areas)
    mask_color_id = 0
    for i in order:
        if scores[i] < thresh:
            continue
        x1, y1, x2, y2 = boxes[i]
        ax.add_patch(
            plt.Rectangle((x1, y1), x2 - x1, y2 - y1, fill=False,
                          edgecolor="g", linewidth=0.5, alpha=box_alpha)
        )
        if show_class:
            c = int(classes[i])
            name = class_names[c] if c < len(class_names) else str(c)
            label = f"{name} {scores[i]:.2f}".replace(" 0.", " .")
            ax.text(x1, y1 - 2, label, fontsize=3, family="serif",
                    bbox=dict(facecolor="g", alpha=0.4, pad=0,
                              edgecolor="none"),
                    color="white")
        if masks is not None and i < masks.shape[2]:
            color = color_list[mask_color_id % len(color_list), :3].copy()
            mask_color_id += 1
            color = color * 0.6 + 0.4  # lighten toward white (w_ratio=.4)
            contours = cv2.findContours(
                masks[:, :, i].copy(), cv2.RETR_CCOMP, cv2.CHAIN_APPROX_NONE
            )[-2]
            for cont in contours:
                ax.add_patch(Polygon(cont.reshape(-1, 2), fill=True,
                                     facecolor=color, edgecolor="w",
                                     linewidth=1.2, alpha=0.5))

    output_dir = output_dir or "."
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, os.path.basename(im_name) + "." + ext)
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
    return out_path


def to_cls_format(
    boxes,
    scores,
    classes,
    rles: Optional[List] = None,
    keypoints=None,
    num_classes: int = 81,
):
    """Flat detections -> Detectron's per-class interchange format
    (``cls_boxes``/``cls_segms``/``cls_keyps``), the structure the
    reference's testing and visualisation code passes around (reference
    result_utils.py:96-168 produces it; vis.py:68-88 consumes it via
    ``convert_from_cls_format``). Lets reference-ecosystem tools consume
    this framework's outputs directly.

    Returns (cls_boxes, cls_segms, cls_keyps): cls_boxes[j] is an (n_j, 5)
    float32 array of [x1, y1, x2, y2, score]; cls_segms[j] a list of RLE
    dicts (None if `rles` is None); cls_keyps[j] a list of (4, P) keypoint
    arrays (None if `keypoints` is None)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    scores = np.asarray(scores, np.float32).reshape(-1)
    classes = np.asarray(classes).astype(int).reshape(-1)
    cls_boxes = [np.zeros((0, 5), np.float32) for _ in range(num_classes)]
    cls_segms = [[] for _ in range(num_classes)] if rles is not None else None
    cls_keyps = [[] for _ in range(num_classes)] if keypoints is not None else None
    for j in range(1, num_classes):
        sel = np.where(classes == j)[0]
        if len(sel) == 0:
            continue
        cls_boxes[j] = np.hstack(
            [boxes[sel], scores[sel, None]]
        ).astype(np.float32)
        if rles is not None:
            cls_segms[j] = [rles[i] for i in sel]
        if keypoints is not None:
            cls_keyps[j] = [np.asarray(keypoints[i]) for i in sel]
    return cls_boxes, cls_segms, cls_keyps

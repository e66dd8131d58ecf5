"""Deterministic synthetic COCO dataset builder.

No real COCO images or Detectron weights exist in this environment, so the
AP-parity harness (tests/test_ap_parity.py) and the end-to-end throughput
benchmark run on a generated dataset: structured scenes of colored geometric
shapes with exact polygon segmentations, written out in standard COCO
instances-json format (the same schema `lib/data/json_dataset.py` consumes
in the reference).

Everything is seeded and content-addressed: the same (seed, n_images, size)
always produces byte-identical annotations and images (PNG, lossless), so
golden numbers recorded against a build stay valid.

The port's own copy of ``detectorch_tpu/data/synth.py``, held to it by
tests/test_torch_host_copies.py: the same code with the port's imports
(numpy and cv2 only).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

# The 80 standard COCO category json ids (1..90 with gaps) in the canonical
# order that maps onto COCO_CLASSES[1:].
COCO_JSON_IDS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90,
]

# Drawable object archetypes: (contiguous class index 1..80, base RGB color,
# shape kind). Colors are far apart so even random-projection features are
# linearly separable — the parity harness trains linear probes on them.
ARCHETYPES = [
    (1, (220, 40, 40), "ellipse"),     # person
    (3, (40, 200, 60), "rect"),        # car
    (16, (40, 80, 230), "triangle"),   # bird
    (17, (230, 220, 40), "ellipse"),   # cat
    (18, (230, 40, 220), "rect"),      # dog
    (44, (40, 230, 220), "triangle"),  # bottle
    (62, (240, 140, 40), "ellipse"),   # chair
    (67, (140, 60, 240), "rect"),      # dining table
]


COCO_PERSON_KEYPOINTS = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]

COCO_PERSON_SKELETON = [
    [16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12], [7, 13],
    [6, 7], [6, 8], [7, 9], [8, 10], [9, 11], [2, 3], [1, 2], [1, 3],
    [2, 4], [3, 5], [4, 6], [5, 7],
]


def _person_keypoints(cx: float, cy: float, rx: float, ry: float,
                      angle: float, x1, y1, x2, y2) -> list:
    """17 deterministic visible keypoints inside the person ellipse: a
    stick-figure layout in the ellipse's own frame, rotated with it, then
    clipped into the bbox. Flat [x, y, v=2] * 17."""
    layout = np.array([
        (0.0, -0.80), (-0.12, -0.88), (0.12, -0.88),       # nose, eyes
        (-0.25, -0.82), (0.25, -0.82),                     # ears
        (-0.40, -0.45), (0.40, -0.45),                     # shoulders
        (-0.55, -0.05), (0.55, -0.05),                     # elbows
        (-0.60, 0.30), (0.60, 0.30),                       # wrists
        (-0.25, 0.10), (0.25, 0.10),                       # hips
        (-0.28, 0.50), (0.28, 0.50),                       # knees
        (-0.30, 0.85), (0.30, 0.85),                       # ankles
    ])
    pts = layout * np.array([rx, ry])
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    pts = pts @ rot.T + np.array([cx, cy])
    pts[:, 0] = np.clip(pts[:, 0], x1, x2)
    pts[:, 1] = np.clip(pts[:, 1], y1, y2)
    out = []
    for x, y in pts:
        out += [float(x), float(y), 2]
    return out


def _polygon_for_shape(kind: str, cx: float, cy: float, rx: float, ry: float,
                       angle: float, rng: np.random.RandomState) -> np.ndarray:
    """Return an (N, 2) float polygon (closed implicitly) for a shape."""
    if kind == "ellipse":
        t = np.linspace(0, 2 * np.pi, 20, endpoint=False)
        pts = np.stack([rx * np.cos(t), ry * np.sin(t)], axis=1)
    elif kind == "rect":
        pts = np.array(
            [[-rx, -ry], [rx, -ry], [rx, ry], [-rx, ry]], np.float64
        )
    elif kind == "triangle":
        t = np.array([0.25, 0.25 + 1 / 3, 0.25 + 2 / 3]) * 2 * np.pi
        pts = np.stack([rx * np.cos(t), ry * np.sin(t)], axis=1)
    else:
        raise ValueError(kind)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    return pts @ rot.T + np.array([cx, cy])


def _shoelace_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(
        float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    )


def build_synth_coco(
    root: str,
    n_images: int = 24,
    height: int = 224,
    width: int = 288,
    seed: int = 0,
    max_objects: int = 5,
    crowd_every: int = 8,
    archetypes: Sequence = ARCHETYPES,
    img_format: str = "png",
    with_keypoints: bool = False,
) -> Tuple[str, str]:
    """Generate images + annotations under `root`.

    Returns (annotation_json_path, image_directory). Idempotent: if the
    manifest matches the requested parameters, the existing files are reused.

    with_keypoints=True makes it a person-keypoints dataset (COCO
    person_keypoints_*.json schema): the person category carries the 17
    standard keypoint names + skeleton, and every non-crowd person
    annotation gets 17 visible keypoints placed deterministically inside
    its ellipse (keypoint eval needs gt with num_keypoints > 0)."""
    import cv2

    from detectorch_tpu_torch.utils.dummy_datasets import COCO_CLASSES

    img_dir = os.path.join(root, "images")
    ann_file = os.path.join(root, "instances_synth.json")
    manifest = os.path.join(root, "manifest.json")
    spec = {"n_images": n_images, "height": height, "width": width,
            "seed": seed, "max_objects": max_objects,
            "crowd_every": crowd_every, "img_format": img_format,
            "with_keypoints": with_keypoints,
            "version": 5}
    if os.path.exists(manifest):
        with open(manifest) as f:
            if json.load(f) == spec:
                return ann_file, img_dir
    os.makedirs(img_dir, exist_ok=True)

    categories = [
        {"id": jid, "name": COCO_CLASSES[i + 1]}
        for i, jid in enumerate(COCO_JSON_IDS)
    ]
    if with_keypoints:
        # person_keypoints_*.json schema: the person category alone, with
        # the standard 17 keypoint names + skeleton; non-person shapes are
        # still drawn as unannotated distractors (like real backgrounds)
        categories = [dict(categories[0],
                           keypoints=COCO_PERSON_KEYPOINTS,
                           skeleton=COCO_PERSON_SKELETON)]
    images, annotations = [], []
    ann_id = 1
    for idx in range(n_images):
        rng = np.random.RandomState(seed * 100003 + idx)
        # background: smooth color gradient + mild noise
        yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
        base = rng.uniform(60, 120, 3)
        gx, gy = rng.uniform(-30, 30, 2)
        im = np.zeros((height, width, 3), np.float32)
        for ch in range(3):
            im[:, :, ch] = base[ch] + gx * xx / width + gy * yy / height

        n_obj = rng.randint(1, max_objects + 1)
        for obj_i in range(n_obj):
            # A keypoint dataset needs persons: force the first object of
            # every image to the person archetype so each image has gt
            # keypoints regardless of seed.
            if with_keypoints and obj_i == 0:
                cls_i, color, kind = archetypes[0]
            else:
                cls_i, color, kind = archetypes[rng.randint(len(archetypes))]
            rx = rng.uniform(14, 60)
            ry = rx * rng.uniform(0.6, 1.6)
            cx = rng.uniform(rx, width - rx)
            cy = rng.uniform(ry, height - ry)
            angle = rng.uniform(0, np.pi)
            poly = _polygon_for_shape(kind, cx, cy, rx, ry, angle, rng)
            poly[:, 0] = np.clip(poly[:, 0], 0, width - 1)
            poly[:, 1] = np.clip(poly[:, 1], 0, height - 1)
            shade = rng.uniform(0.75, 1.15)
            col = tuple(float(np.clip(c * shade, 0, 255)) for c in color)
            cv2.fillPoly(im, [np.round(poly).astype(np.int32)], col)
            x1, y1 = poly.min(axis=0)
            x2, y2 = poly.max(axis=0)
            area = _shoelace_area(poly)
            if area < 16 or x2 - x1 < 4 or y2 - y1 < 4:
                continue
            is_crowd = int(
                crowd_every > 0 and ann_id % crowd_every == 0
            )
            ann = {
                "id": ann_id,
                "image_id": idx + 1,
                "category_id": COCO_JSON_IDS[cls_i - 1],
                "segmentation": [list(map(float, poly.reshape(-1)))],
                "bbox": [float(x1), float(y1),
                         float(x2 - x1 + 1), float(y2 - y1 + 1)],
                "area": float(area),
                "iscrowd": is_crowd,
            }
            if with_keypoints:
                if cls_i != 1:
                    continue  # non-person shapes are unannotated distractors
                if is_crowd:
                    ann["keypoints"] = [0.0] * 51
                    ann["num_keypoints"] = 0
                else:
                    ann["keypoints"] = _person_keypoints(
                        cx, cy, rx, ry, angle, x1, y1, x2, y2
                    )
                    ann["num_keypoints"] = 17
            annotations.append(ann)
            ann_id += 1

        # Texture EVERYTHING (background and shape interiors): multi-frequency
        # sinusoids + pixel noise. Without this, flat-filled regions produce
        # bit-identical conv features at distant positions -> exactly tied
        # RPN scores, whose ordering is undefined in the reference itself
        # (np.argsort/argpartition on ties) — untestable, and unlike any
        # real image.
        tex = rng.randn(height, width, 3).astype(np.float32) * 5.0
        for _ in range(3):
            fx, fy = rng.uniform(0.05, 0.6, 2)
            ph_x, ph_y = rng.uniform(0, 2 * np.pi, 2)
            amp = rng.uniform(2, 6)
            wave = amp * np.sin(fx * xx + ph_x) * np.sin(fy * yy + ph_y)
            tex += wave[:, :, None].astype(np.float32) * rng.uniform(0.3, 1.0, 3)
        im += tex

        fname = f"synth_{idx:05d}.{img_format}"
        cv2.imwrite(
            os.path.join(img_dir, fname),
            np.clip(im, 0, 255).astype(np.uint8)[:, :, ::-1],  # RGB->BGR
        )
        images.append({"id": idx + 1, "file_name": fname,
                       "height": height, "width": width})

    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": categories}, f)
    with open(manifest, "w") as f:
        json.dump(spec, f)
    return ann_file, img_dir


def write_proposals_pkl(
    ann_file: str,
    out_path: str,
    per_image_random: int = 48,
    jitters_per_gt: int = 6,
    seed: int = 1,
) -> str:
    """Precomputed-proposals file for the Fast R-CNN (no-RPN) presets, in the
    reference's pickle schema: {"boxes": [per-image (N,4) xyxy], "ids": [...]}
    (consumed by json_dataset.py:237-266 / data/coco.py). Proposals are
    gt-jitters plus uniform random boxes — deterministic."""
    with open(ann_file) as f:
        coco = json.load(f)
    anns_by_img = {}
    for a in coco["annotations"]:
        anns_by_img.setdefault(a["image_id"], []).append(a)
    boxes_list, ids = [], []
    for img in coco["images"]:
        rng = np.random.RandomState(seed * 7919 + img["id"])
        h, w = img["height"], img["width"]
        boxes = []
        for a in anns_by_img.get(img["id"], []):
            x, y, bw, bh = a["bbox"]
            gt = np.array([x, y, x + bw - 1, y + bh - 1])
            for _ in range(jitters_per_gt):
                j = gt + rng.randn(4) * np.array([bw, bh, bw, bh]) * 0.12
                boxes.append(j)
        for _ in range(per_image_random):
            x1 = rng.uniform(0, w - 16)
            y1 = rng.uniform(0, h - 16)
            boxes.append([x1, y1,
                          x1 + rng.uniform(12, w * 0.6),
                          y1 + rng.uniform(12, h * 0.6)])
        b = np.asarray(boxes, np.float32)
        b[:, [0, 2]] = np.clip(b[:, [0, 2]], 0, w - 1)
        b[:, [1, 3]] = np.clip(b[:, [1, 3]], 0, h - 1)
        boxes_list.append(b)
        ids.append(img["id"])
    # the reference schema carries per-box objectness scores and its loader
    # REQUIRES the field (_sort_proposals, json_dataset.py:438-444) even
    # though nothing downstream reads it; descending dummy scores keep the
    # file loadable by both pipelines
    scores = [np.linspace(1.0, 0.5, len(b), dtype=np.float32)
              for b in boxes_list]
    with open(out_path, "wb") as f:
        pickle.dump({"boxes": boxes_list, "ids": ids, "scores": scores}, f)
    return out_path

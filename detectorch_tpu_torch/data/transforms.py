"""Host-side image preprocessing -> fixed-shape device inputs.

Reference: ``lib/utils/blob.py:57-87`` (mean subtract + shorter-side-800 /
max-1333 resize with cv2 INTER_LINEAR), ``blob.py:27-54`` (padding),
``lib/utils/preprocess_sample.py`` (proposal scaling + dedup).

TPU-first differences:
  * images are RGB float32 NHWC (the BGR convention lives entirely inside
    the checkpoint importer's conv1 flip);
  * padding goes to a small set of static shape buckets so each bucket
    compiles exactly one program (the reference pads per-batch to the max
    sample shape, which would recompile constantly under XLA).

The port's own copy of ``detectorch_tpu/data/transforms.py``, held to it by
tests/test_torch_host_copies.py.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# RGB order (reference stores BGR means [102.98, 115.95, 122.77] for its BGR
# pipeline; same values reversed)
PIXEL_MEANS_RGB = np.array([122.7717, 115.9465, 102.9801], np.float32)


def compute_scale(h: int, w: int, target_size: int = 800, max_size: int = 1333) -> float:
    """reference blob.py:67-77 (incl. the np.round in the cap check)."""
    size_min, size_max = min(h, w), max(h, w)
    scale = float(target_size) / float(size_min)
    if np.round(scale * size_max) > max_size:
        scale = float(max_size) / float(size_max)
    return scale


def resize_image(im: np.ndarray, scale: float) -> np.ndarray:
    """cv2 bilinear resize by a scale factor (reference blob.py:82-84)."""
    import cv2

    return cv2.resize(
        im, None, None, fx=scale, fy=scale, interpolation=cv2.INTER_LINEAR
    )


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_shape(
    h: int, w: int, stride: int = 32,
    buckets: Optional[Sequence[Tuple[int, int]]] = None,
) -> Tuple[int, int]:
    """Smallest static shape that fits (h, w).

    With explicit `buckets`, picks the first (sorted by area) that fits —
    keeping the number of compiled programs tiny. Otherwise rounds each dim
    up to `stride` (one program per aspect bucket).
    """
    if buckets is None:
        return round_up(h, stride), round_up(w, stride)
    for bh, bw in sorted(buckets, key=lambda s: s[0] * s[1]):
        if bh >= h and bw >= w:
            return bh, bw
    raise ValueError(f"no bucket fits {(h, w)} in {buckets}")


# the two standard 800/1333 buckets (landscape, portrait) + square fallback
DEFAULT_BUCKETS = ((832, 1344), (1344, 832), (1344, 1344))


def preprocess_image(
    im_rgb: np.ndarray,
    target_size: int = 800,
    max_size: int = 1333,
    pad_stride: int = 32,
    buckets: Optional[Sequence[Tuple[int, int]]] = DEFAULT_BUCKETS,
    pixel_means: np.ndarray = PIXEL_MEANS_RGB,
):
    """uint8/float RGB HWC -> (padded float32 image, im_scale, (orig_h, orig_w)).

    Gray images are broadcast to 3 channels (reference coco_dataset.py:49-50).
    """
    if im_rgb.ndim == 2:
        im_rgb = np.repeat(im_rgb[:, :, None], 3, axis=2)
    h, w = im_rgb.shape[:2]
    im = im_rgb.astype(np.float32) - pixel_means
    scale = compute_scale(h, w, target_size, max_size)
    im = resize_image(im, scale)
    sh, sw = im.shape[:2]
    ph, pw = bucket_shape(sh, sw, pad_stride, buckets)
    out = np.zeros((ph, pw, 3), np.float32)
    out[:sh, :sw] = im
    return out, scale, (h, w)


def preprocess_image_pyramid(
    im_rgb: np.ndarray,
    target_sizes: Sequence[int],
    max_size: int = 1333,
    pad_stride: int = 32,
    buckets: Optional[Sequence[Tuple[int, int]]] = None,
    pixel_means: np.ndarray = PIXEL_MEANS_RGB,
):
    """Multi-scale image pyramid (reference blob.py:57-87 target_sizes list):
    one (padded image, scale) per target size. Buckets default to exact
    ceil-to-stride padding since pyramid levels span many shapes.

    Parity note: this capability is LATENT in the reference —
    `prep_im_for_blob` accepts a target_sizes list, but every notebook and
    script passes exactly one size, and its repo contains no cross-scale
    detection merging (no TEST.BBOX_AUG equivalent). We go further: the
    engine consumes this pyramid via
    `InferenceEngine.run_image_multiscale` (upstream Detectron
    TEST.BBOX_AUG union semantics — per-scale programs, one reference NMS
    over the union), reachable as `evaluate_dataset(target_sizes=[...])`
    / `tools/eval_coco.py --target-sizes`."""
    out = []
    for ts in target_sizes:
        out.append(
            preprocess_image(
                im_rgb, ts, max_size, pad_stride, buckets, pixel_means
            )
        )
    return out


def dedup_proposals(proposals: np.ndarray, spatial_scale: float = 0.0625):
    """Remove proposals that alias to the same feature-map roi (reference
    preprocess_sample.py:63-70). Returns (unique proposals, inverse index)."""
    v = np.array([1e3, 1e6, 1e9, 1e12])
    hashes = np.round(proposals * spatial_scale).dot(v)
    _, index, inv = np.unique(hashes, return_index=True, return_inverse=True)
    return proposals[index], inv


def pad_proposals(
    proposals: np.ndarray, max_count: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Truncate/pad to a static count with a validity mask."""
    n = min(len(proposals), max_count)
    out = np.zeros((max_count, 4), np.float32)
    out[:n] = proposals[:n]
    valid = np.zeros(max_count, bool)
    valid[:n] = True
    return out, valid


def load_image_rgb(path: str) -> np.ndarray:
    """Read an image file as RGB uint8 (reference uses skimage.io.imread,
    which also returns RGB)."""
    import cv2

    im = cv2.imread(path, cv2.IMREAD_COLOR)
    if im is None:
        raise FileNotFoundError(path)
    return im[:, :, ::-1].copy()

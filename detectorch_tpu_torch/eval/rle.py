"""COCO RLE mask codec + run-based mask ops (no pycocotools dependency).

The reference leans on ``pycocotools.mask`` (RLE encode in segm_results,
reference ``lib/utils/result_utils.py:218-221``; RLE IoU for crowd filtering
in ``lib/data/json_dataset.py:397-414``). That C library is not available
here, so this module implements the same public format natively:

  * binary mask <-> uncompressed counts (column-major, runs alternate
    0s/1s starting with a 0-run) — `encode_counts` / `decode_counts`;
  * counts <-> the COCO compressed ascii string (signed 5-bit varint with
    second-order differences) — `counts_to_string` / `string_to_counts`,
    byte-compatible with pycocotools' rleToString/rleFrString;
  * polygon -> mask rasterisation (`polygons_to_mask`);
  * run-walk intersection areas and IoU with the crowd convention
    (`rle_iou`), no full-mask decode.

These run on the host (RLE is inherently sequential/byte-oriented). The
port's copy of ``detectorch_tpu/eval/rle.py``. As there, the hot loops — the
paste encode, the string codec, the run-walk IoU — run in C++: the port's own
plain-C library (``eval/rle_native``, ``csrc/rle_native.cpp``), built at
first use; so does ``area``. A failed build raises: there is no fallback. The
numpy bodies stay beside them as the plain versions (``*_np``), which the
tests and ``chip_smoke.py`` hold the library to, byte for byte.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from detectorch_tpu_torch.eval.rle_native import library as _native

RLE = Dict[str, object]  # {'size': [h, w], 'counts': str | list[int]}


# ---------------------------------------------------------------------------
# binary mask <-> counts
# ---------------------------------------------------------------------------


def encode_counts(mask: np.ndarray) -> List[int]:
    """mask (H, W) {0,1} -> run lengths, column-major, starting with zeros."""
    flat = np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F")
    if flat.size == 0:
        return [0]
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return counts


def decode_counts(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    """Run lengths -> (H, W) uint8 mask."""
    total = int(np.sum(counts))
    assert total == h * w, f"counts sum {total} != {h}*{w}"
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, np.asarray(counts, np.int64))
    return flat.reshape(h, w, order="F")


# ---------------------------------------------------------------------------
# counts <-> COCO compressed string (pycocotools-compatible)
# ---------------------------------------------------------------------------


def counts_to_string(counts: Sequence[int]) -> str:
    """Signed 5-bit varint encoding with 2nd-order differences (maskApi
    rleToString semantics)."""
    return _native.counts_to_string(counts)


def counts_to_string_np(counts: Sequence[int]) -> str:
    """counts_to_string's plain version."""
    s = []
    cnts = list(counts)
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def string_to_counts(s: Union[str, bytes]) -> List[int]:
    """maskApi rleFrString semantics."""
    return _native.string_to_counts(s)


def string_to_counts_np(s: Union[str, bytes]) -> List[int]:
    """string_to_counts's plain version."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode(mask: np.ndarray) -> RLE:
    """Binary mask -> COCO RLE dict with compressed string counts (the
    format `segm_results` stores into results json)."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": counts_to_string(encode_counts(mask))}


def encode_pasted(binary: np.ndarray, x0: int, y0: int, im_h: int, im_w: int) -> RLE:
    """RLE of a (bh, bw) binary patch pasted at (x0, y0) into an otherwise
    zero (im_h, im_w) canvas — WITHOUT materialising the canvas.

    Column-major runs touch only the patch's own columns; everything left of
    x0 is one leading zero-run and everything right of x0+bw one trailing
    zero-run, both merged arithmetically. Byte-identical to
    ``encode(canvas)`` (tested) at O(im_h*bw) instead of O(im_h*im_w) — this
    is the hot path of mask pasting (segm_results runs it per detection)."""
    return {"size": [int(im_h), int(im_w)],
            "counts": _native.encode_pasted(binary, x0, y0, im_h, im_w)}


def encode_pasted_np(binary: np.ndarray, x0: int, y0: int, im_h: int, im_w: int) -> RLE:
    """encode_pasted's plain version: a zero strip of the patch's columns,
    encoded in numpy, with the leading and trailing zero columns merged."""
    bh, bw = binary.shape
    if bh == 0 or bw == 0:
        return {"size": [int(im_h), int(im_w)],
                "counts": counts_to_string_np([im_h * im_w])}
    strip = np.zeros((im_h, bw), np.uint8)
    strip[y0:y0 + bh] = binary
    counts = encode_counts(strip)
    counts[0] += x0 * im_h                  # leading zero columns
    tail = (im_w - x0 - bw) * im_h          # trailing zero columns
    if tail:
        if len(counts) % 2 == 0:            # last run is a 1-run
            counts.append(tail)
        else:
            counts[-1] += tail
    return {"size": [int(im_h), int(im_w)], "counts": counts_to_string_np(counts)}


def decode(rle: RLE) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return decode_counts(counts, h, w)


def area(rle: RLE) -> int:
    return _native.area(_as_counts(rle))


def area_np(rle: RLE) -> int:
    """area's plain version."""
    return int(np.sum(_as_counts_np(rle)[1::2]))


def to_bbox(rle: RLE) -> np.ndarray:
    """RLE -> [x, y, w, h] tight bbox (maskApi rleToBbox semantics)."""
    h, w = rle["size"]
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        return np.zeros(4, np.float32)
    return np.array(
        [xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1],
        np.float32,
    )


# ---------------------------------------------------------------------------
# polygons -> mask
# ---------------------------------------------------------------------------


def polygons_to_mask(polys: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """COCO polygon segmentation -> (H, W) uint8 mask (union of polygons).

    Uses cv2.fillPoly, which matches pycocotools' frPoly rasterisation
    closely enough for training targets and eval IoUs.
    """
    import cv2

    mask = np.zeros((h, w), np.uint8)
    pts = [
        np.round(np.asarray(p, np.float64)).reshape(-1, 2).astype(np.int32)
        for p in polys
        if len(p) >= 6
    ]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask


def segmentation_to_rle(segm, h: int, w: int) -> RLE:
    """Any COCO segmentation payload (polygons / uncompressed counts list /
    compressed string) -> compressed RLE."""
    if isinstance(segm, list):
        return encode(polygons_to_mask(segm, h, w))
    counts = segm["counts"]
    if isinstance(counts, list):
        return {"size": list(segm["size"]), "counts": counts_to_string(counts)}
    return {"size": list(segm["size"]), "counts": counts}


# ---------------------------------------------------------------------------
# run-based intersection / IoU
# ---------------------------------------------------------------------------


def _one_intervals(counts: Sequence[int]) -> np.ndarray:
    """Runs -> (K, 2) [start, end) intervals of the 1-pixels in flat order."""
    c = np.asarray(counts, np.int64)
    bounds = np.cumsum(c)
    # counts alternate [zeros, ones, zeros, ones, ...]: the i-th 1-run spans
    # [bounds[2i], bounds[2i+1])
    starts = bounds[0::2]
    ends = bounds[1::2]
    n = min(len(starts), len(ends))
    iv = np.stack([starts[:n], ends[:n]], axis=1)
    return iv[iv[:, 1] > iv[:, 0]]


def _interval_intersection(a: np.ndarray, b: np.ndarray) -> int:
    """Total overlap length between two sorted disjoint interval sets."""
    if len(a) == 0 or len(b) == 0:
        return 0
    # for each interval in a, find candidate range in b
    lo = np.searchsorted(b[:, 1], a[:, 0], side="right")
    hi = np.searchsorted(b[:, 0], a[:, 1], side="left")
    total = 0
    for i in range(len(a)):
        if lo[i] >= hi[i]:
            continue
        seg = b[lo[i] : hi[i]]
        total += int(
            np.sum(np.minimum(seg[:, 1], a[i, 1]) - np.maximum(seg[:, 0], a[i, 0]))
        )
    return total


def _as_counts(rle: RLE) -> List[int]:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return counts


def _as_counts_np(rle: RLE) -> List[int]:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts_np(counts)
    return counts


def rle_intersection_area(a: RLE, b: RLE) -> int:
    return _interval_intersection(
        _one_intervals(_as_counts(a)), _one_intervals(_as_counts(b))
    )


def rle_iou(dts: List[RLE], gts: List[RLE], iscrowd: Sequence[bool]) -> np.ndarray:
    """(D, G) IoU matrix with the COCO crowd convention: for crowd gt,
    iou = intersection / dt_area (pycocotools iou semantics)."""
    return _native.iou_matrix([_as_counts(d) for d in dts], [_as_counts(g) for g in gts],
                              iscrowd)


def rle_iou_np(dts: List[RLE], gts: List[RLE], iscrowd: Sequence[bool]) -> np.ndarray:
    """rle_iou's plain version."""
    d_iv = [_one_intervals(_as_counts_np(d)) for d in dts]
    g_iv = [_one_intervals(_as_counts_np(g)) for g in gts]
    d_area = [int(np.sum(iv[:, 1] - iv[:, 0])) for iv in d_iv]
    g_area = [int(np.sum(iv[:, 1] - iv[:, 0])) for iv in g_iv]
    out = np.zeros((len(dts), len(gts)), np.float64)
    for i in range(len(dts)):
        for j in range(len(gts)):
            inter = _interval_intersection(d_iv[i], g_iv[j])
            if iscrowd[j]:
                denom = d_area[i]
            else:
                denom = d_area[i] + g_area[j] - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def merge_union(rles: List[RLE]) -> RLE:
    """Union of masks (pycocotools merge(intersect=False))."""
    assert rles
    h, w = rles[0]["size"]
    m = np.zeros((h, w), bool)
    for r in rles:
        m |= decode(r).astype(bool)
    return encode(m.astype(np.uint8))

"""The port's native RLE (``csrc/rle_native.cpp`` through
``eval/rle_native``) against its numpy plain versions (``eval/rle.*_np``) and
against the JAX package's ``eval/rle``.

The JAX package's CPython extension (``native/rle_ext.cpp``) is not built
here, so its ``eval/rle`` runs numpy: all three must agree byte for byte —
strings equal, counts equal as lists of ints, IoU matrices bit for bit —
on random masks, on pastes at the canvas's edges, on counts past 2**31,
with crowd gts, and through ``segm_results`` and COCOeval's segm stats.
The library is built here with the host compiler at first use; two
processes building into one empty directory agree on one file, and a
failed build raises with the compiler's output.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from detectorch_tpu.eval import coco_eval as jce
from detectorch_tpu.eval import mask_paste as jmp
from detectorch_tpu.eval import rle as jrle
from detectorch_tpu_torch.eval import coco_eval as tce
from detectorch_tpu_torch.eval import mask_paste as tmp
from detectorch_tpu_torch.eval import rle as trle
from detectorch_tpu_torch.eval import rle_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 37, 53


def _use_numpy(monkeypatch):
    """The port's eval/rle with its plain versions in place of the library,
    for every caller that reaches them through the module's attributes."""
    for name in ("counts_to_string", "string_to_counts", "encode_pasted", "area", "rle_iou"):
        monkeypatch.setattr(trle, name, getattr(trle, f"{name}_np"))


def _masks(rng, n, h, w):
    out = [(rng.rand(h, w) < p).astype(np.uint8) for p in rng.uniform(0.05, 0.95, n)]
    yy, xx = np.mgrid[:h, :w]
    for _ in range(n):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(2, h)
        out.append(((xx - cx) ** 2 + (yy - cy) ** 2 < r * r).astype(np.uint8))
    out += [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8)]
    return out


def test_jax_native_module_is_not_built_here():
    # the JAX side of every comparison below is its numpy code
    assert jrle._native is None


def test_codec_matches_on_random_masks():
    rng = np.random.RandomState(0)
    for m in _masks(rng, 12, H, W):
        counts = trle.encode_counts(m)
        s = trle.counts_to_string(counts)
        assert s == trle.counts_to_string_np(counts) == jrle.counts_to_string(counts)
        back = trle.string_to_counts(s)
        assert type(back) is list and all(type(c) is int for c in back)
        assert back == trle.string_to_counts_np(s) == jrle.string_to_counts(s) == counts
        assert trle.string_to_counts(s.encode()) == counts
        rle = trle.encode(m)
        assert rle == jrle.encode(m)
        assert np.array_equal(trle.decode(rle), m)
        assert trle.area(rle) == trle.area_np(rle) == jrle.area(rle) == int(m.sum())
        assert type(trle.area(rle)) is int


@pytest.mark.parametrize("counts", [
    [0, 2 ** 31, 5, 2 ** 31 + 1],
    [2 ** 33, 7, 2 ** 40 + 3, 1, 2 ** 32, 2 ** 31 - 1, 12345678901],
    [3, 2 ** 62, 0, 2 ** 62 + 11],
], ids=["2^31", "2^40", "2^62"])
def test_codec_past_2_31(counts):
    s = trle.counts_to_string(counts)
    assert s == trle.counts_to_string_np(counts) == jrle.counts_to_string(counts)
    assert trle.string_to_counts(s) == trle.string_to_counts_np(s) == counts
    rle = {"size": [1, sum(counts)], "counts": s}
    assert trle.area(rle) == trle.area_np(rle) == jrle.area(rle)


def test_truncated_string_raises():
    # the last character says another follows
    s = trle.counts_to_string([5, 2 ** 20])
    with pytest.raises(ValueError, match="truncated"):
        trle.string_to_counts(s[:-1] + chr(((ord(s[-1]) - 48) | 0x20) + 48))


def _pastes(rng):
    """(patch, x0, y0): at x0 = 0, at the right and bottom edges, in both
    corners, inside, empty, a full-canvas patch, one pixel, 1-runs across a
    column wrap."""
    def patch(h, w, p=0.5):
        return (rng.rand(h, w) < p).astype(np.uint8)

    full_col = np.ones((H, 3), np.uint8)
    return [
        (patch(10, 12), 0, 4), (patch(10, 12), W - 12, 4), (patch(10, 12), 9, H - 10),
        (patch(10, 12), W - 12, H - 10), (patch(10, 12), 0, 0), (patch(15, 20), 7, 5),
        (np.zeros((0, 0), np.uint8), 0, 0), (np.zeros((0, 5), np.uint8), 3, 3),
        (np.zeros((6, 7), np.uint8), 4, 4), (np.ones((H, W), np.uint8), 0, 0),
        (patch(H, W, 0.9), 0, 0), (np.ones((1, 1), np.uint8), W - 1, H - 1),
        (full_col, 5, 0), (full_col, 0, 0), (full_col, W - 3, 0),
        (patch(H - 2, 4, 0.95), 11, 2),
    ]


def test_encode_pasted_matches_at_the_edges():
    rng = np.random.RandomState(1)
    for patch, x0, y0 in _pastes(rng):
        got = trle.encode_pasted(patch, x0, y0, H, W)
        assert got == trle.encode_pasted_np(patch, x0, y0, H, W) \
            == jrle.encode_pasted(patch, x0, y0, H, W), (patch.shape, x0, y0)
        canvas = np.zeros((H, W), np.uint8)
        canvas[y0:y0 + patch.shape[0], x0:x0 + patch.shape[1]] = patch
        assert got == trle.encode(canvas)
    # a non-contiguous crop and a bool patch, as segm_results may pass
    big = (rng.rand(30, 40) < 0.5)
    crop = big[3:20:2, 5:30]
    assert trle.encode_pasted(crop, 2, 1, H, W) == jrle.encode_pasted(crop.astype(np.uint8),
                                                                      2, 1, H, W)


def test_encode_pasted_long_string_and_bad_placement():
    rng = np.random.RandomState(2)
    noise = (rng.rand(300, 200) < 0.5).astype(np.uint8)  # ~30000 runs: past the first buffer
    assert trle.encode_pasted(noise, 10, 20, 400, 260) == \
        jrle.encode_pasted(noise, 10, 20, 400, 260)
    for x0, y0 in ((-1, 0), (0, -1), (W - 11, 0), (0, H - 9)):
        with pytest.raises(ValueError, match="does not fit"):
            trle.encode_pasted(np.ones((10, 12), np.uint8), x0, y0, H, W)


def test_rle_iou_matches_with_crowd_gts():
    rng = np.random.RandomState(3)
    masks = _masks(rng, 5, H, W)
    enc = [trle.encode(m) for m in masks]
    crowd = [bool(c) for c in rng.rand(len(enc)) < 0.4]
    crowd[1], crowd[2] = True, False
    got = trle.rle_iou(enc[:7], enc, crowd)
    for exp in (trle.rle_iou_np(enc[:7], enc, crowd), jrle.rle_iou(enc[:7], enc, crowd)):
        assert got.dtype == exp.dtype == np.float64 and got.shape == exp.shape
        assert np.array_equal(got, exp)
    # uncompressed counts, and empty sides
    raw = [{"size": [H, W], "counts": trle.encode_counts(m)} for m in masks[:3]]
    assert np.array_equal(trle.rle_iou(raw, enc[:2], [0, 1]), jrle.rle_iou(raw, enc[:2], [0, 1]))
    assert trle.rle_iou([], enc, crowd).shape == (0, len(enc))
    assert trle.rle_iou(enc, [], []).shape == (len(enc), 0)


def _segm_case(rng, n=40, h=80, w=100):
    masks = rng.uniform(0, 1, (n, 28, 28)).astype(np.float32)
    x1, y1 = rng.uniform(-20, w - 10, n), rng.uniform(-20, h - 10, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(2, 60, n), y1 + rng.uniform(2, 40, n)], 1)
    boxes[-1] = [w + 5, h + 5, w + 20, h + 20]  # wholly outside: the empty paste
    return masks, boxes.astype(np.float32), h, w


def test_segm_results_with_and_without_the_library(monkeypatch):
    masks, boxes, h, w = _segm_case(np.random.RandomState(4))
    native = tmp.segm_results(masks, boxes, h, w, 28)
    assert sum(trle.area(r) for r in native) > 0
    _use_numpy(monkeypatch)
    plain = tmp.segm_results(masks, boxes, h, w, 28)
    assert native == plain == jmp.segm_results(masks, boxes, h, w, 28)


def _eval_set(tmp_path):
    """Three images with crowd and polygon gts, and mask detections pasted
    by segm_results around them."""
    from detectorch_tpu_torch.data.synth import build_synth_coco

    ann, _ = build_synth_coco(str(tmp_path / "ds"), n_images=3, height=80, width=100, seed=2)
    with open(ann) as f:
        data = json.load(f)
    assert any(a["iscrowd"] for a in data["annotations"])
    rng = np.random.RandomState(5)
    results = []
    for a in data["annotations"]:
        img = next(i for i in data["images"] if i["id"] == a["image_id"])
        x, y, bw, bh = a["bbox"]
        boxes = np.array([[x, y, x + bw, y + bh]] * 3, np.float32) + rng.randn(3, 4) * 3
        masks = (rng.uniform(0, 1, (3, 28, 28)) * 0.6 + 0.2).astype(np.float32)
        for r, s in zip(tmp.segm_results(masks, boxes, img["height"], img["width"], 28),
                        rng.uniform(0.1, 1, 3)):
            results.append({"image_id": a["image_id"], "category_id": a["category_id"],
                            "segmentation": r, "score": float(s)})
    return ann, results


def _segm_eval(mod, ann, results):
    gt = mod.COCO(ann)
    ev = mod.COCOeval(gt, gt.load_res(results), "segm")
    ev.evaluate()
    ev.accumulate()
    ev.summarize(verbose=False)
    return ev


def test_coco_eval_segm_with_and_without_the_library(tmp_path, monkeypatch):
    ann, results = _eval_set(tmp_path)
    native = _segm_eval(tce, ann, results)
    _use_numpy(monkeypatch)
    plain = _segm_eval(tce, ann, results)
    jax_ev = _segm_eval(jce, ann, results)
    assert 0 < native.stats[0] < 1  # a real evaluation
    for ev in (plain, jax_ev):
        assert np.array_equal(native.stats, ev.stats)
        assert np.array_equal(native.eval["precision"], ev.eval["precision"])
        assert native.ious.keys() == ev.ious.keys()
        assert all(np.array_equal(native.ious[k], ev.ious[k]) for k in native.ious)


BUILD_AND_USE = """
import sys
from pathlib import Path
from detectorch_tpu_torch.eval import rle_native
lib = rle_native.Library(Path(sys.argv[1]))
assert lib.counts_to_string([3, 2 ** 33, 1]) == sys.argv[2]
print(lib.path)
"""


def test_two_processes_build_into_an_empty_dir_at_once(tmp_path):
    build_dir = tmp_path / "build"
    want = trle.counts_to_string_np([3, 2 ** 33, 1])
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_USE, str(build_dir), want],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(build_dir)) == [os.path.basename(paths.pop())]


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'fake-cxx: cannot compile' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(RuntimeError, match="fake-cxx: cannot compile"):
        rle_native.Library(tmp_path / "build").counts_to_string([1])
    assert os.listdir(tmp_path / "build") == []  # no temp file left behind
    monkeypatch.delenv("CXX")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="needs a C\\+\\+ compiler"):
        rle_native.build_library(tmp_path / "other")

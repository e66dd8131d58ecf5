"""Keypoint R-CNN evaluation and the CLIs, on a person-keypoints set made by
the port's data/synth copy: both engines and multi-scale inference through
``evaluate_dataset`` against the JAX package's, then ``tools/eval_coco``
and ``tools/train_fast --keypoints`` (host-sampled and ``--e2e``).

e2e_keypoint_rcnn_R-50-FPN_1x with a small keypoint head
(KeypointConfig(num_convs=2, conv_dim=32)), fp32, RPN 100 -> 20, 5
detections (+ 8 tie slots) at score_thresh 0, 96x128 images, one torch
thread; JAX's FPN RoIAlign is its exact gather. Random weights place no
keypoint near a gt, so the set is scored against gts made from JAX's own
first run: each image's two best detections as persons with their decoded
keypoints, so that the OKS stats are far from 0 and move when a keypoint
does.

Tolerances (fp32): detections as tests/test_torch_engine.py (the same
count per image, boxes within rtol 1e-4 / atol 1e-3 in score order);
keypoints of paired detections within 1e-3 px, or, at a near-tied argmax,
in another bin with the same score (tests/test_torch_kp_detector.py) -- at
most 2% of them; the 10 OKS stats within 2e-4 of JAX's, as the AP harness
holds every stat, and the 12 bbox stats too.
"""

import json
import os

import numpy as np
import pytest
import torch

from detectorch_tpu.data.coco import CocoDataset as JaxCocoDataset
from detectorch_tpu.eval import engine as jengine
from detectorch_tpu.models.detector import init_params
from detectorch_tpu_torch import config as torch_config
from detectorch_tpu_torch.checkpoint import caffe2_import as c2
from detectorch_tpu_torch.checkpoint import store
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.data.coco import CocoDataset
from detectorch_tpu_torch.data.synth import build_synth_coco
from detectorch_tpu_torch.eval import engine as E
from detectorch_tpu_torch.tools import eval_coco, train_fast
from tests.torch_configs import both_configs

KP = "e2e_keypoint_rcnn_R-50-FPN_1x"
STAT_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(config):
    """The test's configuration of the keypoint preset, from `config`."""
    return config.PRESETS[KP].replace(
        compute_dtype="float32", use_pallas_roi_align=False,
        rpn=config.RPNConfig(pre_nms_top_n=100, post_nms_top_n=20),
        keypoint=config.KeypointConfig(num_convs=2, conv_dim=32))


CFG, PCFG = both_configs(_small)
TCFG, PTCFG = both_configs(lambda c: c.TestConfig(
    target_size=96, max_size=128, detections_per_img=5, score_thresh=0.0, exact_blob_dims=True))


@pytest.fixture(scope="module")
def kp_set(tmp_path_factory):
    """The data/synth person-keypoints set (4 images), the weights, and a
    second annotation file whose persons are JAX's own first detections."""
    root = tmp_path_factory.mktemp("kp_engine")
    ann, imdir = build_synth_coco(str(root / "ds"), n_images=4, height=96, width=128, seed=8,
                                  with_keypoints=True)
    params = {k: np.asarray(v) for k, v in init_params(CFG, seed=0).items()}
    _, _, info = jengine.evaluate_dataset(CFG, TCFG, params, JaxCocoDataset(ann, imdir),
                                          verbose=False)
    with open(ann) as f:
        coco = json.load(f)
    anns = []
    for image in coco["images"]:
        res = sorted((r for r in info["keypoints"] if r["image_id"] == image["id"]),
                     key=lambda r: -r["score"])[:2]
        for r in res:
            box = next(b["bbox"] for b in info["bbox"] if b["image_id"] == image["id"]
                       and b["score"] == r["score"])
            kps = np.reshape(r["keypoints"], (-1, 3))
            kps[:, 2] = 2
            anns.append({"id": len(anns) + 1, "image_id": image["id"], "category_id": 1,
                         "bbox": box, "area": float(box[2] * box[3]), "iscrowd": 0,
                         "keypoints": [float(v) for v in kps.ravel()], "num_keypoints": 17,
                         "segmentation": [[box[0], box[1], box[0] + box[2], box[1],
                                           box[0] + box[2], box[1] + box[3], box[0],
                                           box[1] + box[3]]]})
    coco["annotations"] = anns
    own = str(root / "own.json")
    with open(own, "w") as f:
        json.dump(coco, f)
    return ann, own, imdir, params, root


def _jax_eval(ann, imdir, params, **kw):
    return jengine.evaluate_dataset(CFG, TCFG, params, JaxCocoDataset(ann, imdir),
                                    verbose=False, **kw)


def _port_eval(ann, imdir, params, tcfg=PTCFG, **kw):
    return E.evaluate_dataset(PCFG, tcfg, params_from_jax(params), CocoDataset(ann, imdir),
                              verbose=False, device="cpu", **kw)


def check_results(got, exp):
    """The same detections per image as JAX's, and their keypoints."""
    def by_image(results):
        out = {}
        for r in results:
            out.setdefault(r["image_id"], []).append(r)
        return {k: sorted(v, key=lambda r: -r["score"]) for k, v in out.items()}

    gb, eb = by_image(got["bbox"]), by_image(exp["bbox"])
    gk, ek = by_image(got["keypoints"]), by_image(exp["keypoints"])
    assert sorted(gb) == sorted(eb) and sorted(gk) == sorted(eb)
    tipped = compared = 0
    for image in eb:
        assert len(gb[image]) == len(eb[image]) == len(gk[image]) == len(ek[image]) > 0
        for x, y in zip(gb[image], eb[image]):
            assert x["category_id"] == y["category_id"] == 1
            np.testing.assert_allclose(x["bbox"], y["bbox"], rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(x["score"], y["score"], rtol=1e-4, atol=1e-6)
        for x, y in zip(gk[image], ek[image]):
            a, b = np.reshape(x["keypoints"], (-1, 3)), np.reshape(y["keypoints"], (-1, 3))
            np.testing.assert_array_equal(a[:, 2], b[:, 2])
            far = (np.abs(a[:, :2] - b[:, :2]) > 1e-3).any(axis=1)
            tipped += int(far.sum())
            compared += len(a)
            np.testing.assert_allclose(x["score"], y["score"], rtol=1e-4, atol=1e-6)
    assert tipped <= 0.02 * compared, (tipped, compared)


def check_stats(got, exp, got_info, exp_info):
    assert got_info["keypoints_stats"] is not None and len(got_info["keypoints_stats"]) == 10
    np.testing.assert_allclose(got_info["keypoints_stats"], exp_info["keypoints_stats"],
                               rtol=0, atol=STAT_TOL)
    np.testing.assert_allclose(got, exp, rtol=0, atol=STAT_TOL)


@pytest.mark.parametrize("batch_size", [1, 3], ids=["single", "batched"])
def test_kp_eval_matches_jax(kp_set, batch_size):
    """Both engines (batch 3: a tail of 1) against JAX's single-image loop,
    scored on the set of JAX's own detections."""
    _, own, imdir, params, _ = kp_set
    exp_bbox, exp_segm, exp = _jax_eval(own, imdir, params)
    got_bbox, got_segm, got = _port_eval(own, imdir, params, batch_size=batch_size)
    assert got_segm is None and exp_segm is None
    assert exp["keypoints_stats"][0] > 0.3  # the gts are JAX's detections
    check_results(got, exp)
    check_stats(got_bbox, exp_bbox, got, exp)


def test_kp_multiscale_and_confidence_match_jax(kp_set):
    """Multi-scale inference (the keypoint branch once, on the merged boxes
    at the first scale: make_keypoint_fn) and the 'prob' keypoint score."""
    _, own, imdir, params, _ = kp_set
    kw = dict(target_sizes=[96, 80])
    exp_bbox, _, exp = jengine.evaluate_dataset(
        CFG, TCFG.replace(keypoint_confidence="prob"), params, JaxCocoDataset(own, imdir),
        verbose=False, **kw)
    got_bbox, _, got = _port_eval(own, imdir, params,
                                  tcfg=PTCFG.replace(keypoint_confidence="prob"), **kw)
    check_results(got, exp)
    check_stats(got_bbox, exp_bbox, got, exp)
    # the 'prob' score is the mean probability of the keypoints, not the box's
    assert {r["score"] for r in got["keypoints"]} != {r["score"] for r in got["bbox"]}


def _patch_small(monkeypatch):
    """The CLIs build the preset from PRESETS and TestConfig(): the test's
    small head and counts, and blobs of 96x128."""
    monkeypatch.setitem(torch_config.PRESETS, KP, torch_config.PRESETS[KP].replace(
        rpn=PCFG.rpn, keypoint=PCFG.keypoint))
    test_config = torch_config.TestConfig
    monkeypatch.setattr(torch_config, "TestConfig", lambda **kw: test_config(**{
        "target_size": 96, "max_size": 128, "exact_blob_dims": True, "detections_per_img": 5,
        "score_thresh": 0.0, **kw}))


def test_eval_coco_cli_keypoints(kp_set, monkeypatch, capsys):
    """tools/eval_coco on the keypoint preset from a Detectron pkl: box and
    keypoint AP printed, keypoint results written, those of
    evaluate_dataset."""
    ann, _, imdir, params, root = kp_set
    _patch_small(monkeypatch)
    pkl = str(root / "kp.pkl")
    c2.save_caffe2_pkl(params_from_jax(params), PCFG, pkl)
    out = str(root / "kp_results.json")
    eval_coco.main(["--preset", KP, "--weights", pkl, "--ann", ann, "--imdir", imdir,
                    "--out", out, "--fp32", "--exact-blob", "--target-sizes", "96",
                    "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("box AP: ") for line in lines) == 1
    assert sum(line.startswith("keypoint AP: ") for line in lines) == 1
    assert not any(line.startswith("mask AP") for line in lines)
    with open(out) as f:
        res = json.load(f)
    assert len(res["keypoints"]) == len(res["bbox"]) > 0 and not res["segm"]
    assert {r["image_id"] for r in res["keypoints"]} == {1, 2, 3, 4}
    assert all(len(r["keypoints"]) == 51 for r in res["keypoints"])


@pytest.mark.parametrize("flags", [[], ["--e2e", "--device-preprocess"]],
                         ids=["host-sampled", "e2e"])
def test_train_fast_keypoints(kp_set, monkeypatch, capsys, flags):
    """tools/train_fast --keypoints (gt rois, no proposal file) and with
    --e2e: two iterations on the person-keypoints set log loss_kps and
    write a checkpoint whose keypoint head moved."""
    ann, _, imdir, _, root = kp_set
    _patch_small(monkeypatch)
    out = str(root / ("kp_run" + "_".join(flags)))
    train_fast.main(["--keypoints", "--ann", ann, "--imdir", imdir, "--out", out,
                     "--max-iter", "2", "--checkpoint-period", "2", "--log-period", "1",
                     "--base-lr", "0.001", "--target-size", "96", "--max-size", "128",
                     "--blob", "96", "128", "--rois-per-image", "16", "--batch-size", "2",
                     "--device", "cpu", *flags])
    logged = capsys.readouterr().out
    assert logged.count("json_stats") == 2 and "loss_kps" in logged
    assert ("loss_rpn_cls" in logged) == ("--e2e" in flags)
    saved = store.restore_checkpoint(os.path.join(out, "ckpt-2"))["params"]
    init = params_from_jax(init_params(CFG, seed=3))
    assert set(saved) == set(init)
    for k in ("conv_fcn1_w", "conv_fcn2_w", "kps_score_lowres_w", "fc6_w"):
        assert not torch.equal(saved[k], init[k]), k

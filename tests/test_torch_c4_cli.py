"""The port's command-line tools on the C4 presets, on the CPU, on synthetic
COCO sets (``detectorch_tpu.data.synth``):

  * ``tools.make_proposals --preset e2e_faster_rcnn_R-50-C4_2x`` against the
    JAX package's ``tools/make_proposals.py`` on the same Detectron pkl, as
    tests/test_torch_make_proposals.py holds the FPN preset: the same ids,
    proposal counts and boxes in the same order within 3e-3 px;
  * ``tools.train_fast`` without ``--fpn``: Fast R-CNN R-50-C4 from those
    proposals (the loop that Detectron's rpn_generate closes), and e2e Mask
    R-CNN R-50-C4 with --device-preprocess and --prefetch;
  * ``tools.eval_coco`` on a C4 preset: the Detectron pkl (--weights) and a
    trainer checkpoint of the same params (--ckpt) write the same results,
    and Fast R-CNN C4 evaluates from the port's proposal file.

The weights are those of tests/test_torch_c4_engine.py: init_params with
two confident classes (cls_score_w scaled by 1e-3, a bias of 3 on classes
1 and 2; random weights score every class near 1/81, under the 0.05
threshold) and the RPN's and box head's delta weights scaled by 0.05 and
0.01: the random C4 trunk reaches ~970 on these images and its RPN deltas
~16 at full scale, where fp32 summation-order drift through exp() moves
boxes by several 1e-3 px; trained RPNs give deltas of a few tenths.
"""

import dataclasses
import importlib.util
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import detectorch_tpu.config as jax_config
import detectorch_tpu_torch.config as torch_config
from detectorch_tpu.data.synth import build_synth_coco
from detectorch_tpu_torch.checkpoint import caffe2_import as c2
from detectorch_tpu_torch.checkpoint import store
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.models.detector import init_params
from detectorch_tpu_torch.tools import eval_coco, make_proposals
from detectorch_tpu_torch.train.train_step import make_train_step, state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FASTER, FAST = "e2e_faster_rcnn_R-50-C4_2x", "fast_rcnn_R-50-C4_2x"
MASK = "e2e_mask_rcnn_R-50-C4_2x"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("c4cli")
    ann, imdir = build_synth_coco(str(root / "ds"), n_images=3, height=96, width=128, seed=12)
    return ann, imdir, root


def _weights(preset, path):
    cfg = torch_config.PRESETS[preset]
    p = init_params(cfg, seed=123)
    p["cls_score_w"] = p["cls_score_w"] * np.float32(1e-3)
    p["cls_score_b"][[1, 2]] = 3.0
    p["bbox_pred_w"] = p["bbox_pred_w"] * np.float32(1e-2)
    if "rpn_bbox_pred_w" in p:
        p["rpn_bbox_pred_w"] = p["rpn_bbox_pred_w"] * np.float32(0.05)
    params = params_from_jax(p)
    c2.save_caffe2_pkl(params, cfg, path)
    return params


def _small(monkeypatch, config, **test_kw):
    """Patch `config` (either side's config module) to the test's sizes:
    every C4 preset at RPN 300 -> 64, and a TestConfig of 96x128 blobs."""
    for preset in (FASTER, FAST, MASK):
        cfg = config.PRESETS[preset]
        monkeypatch.setitem(config.PRESETS, preset, cfg.replace(
            rpn=dataclasses.replace(cfg.rpn, pre_nms_top_n=300, post_nms_top_n=64)))
    test_config = config.TestConfig
    monkeypatch.setattr(config, "TestConfig", lambda **kw: test_config(**{
        "target_size": 96, "max_size": 128, "exact_blob_dims": True, **test_kw, **kw}))


@pytest.fixture(scope="module")
def proposals(dataset, tmp_path_factory):
    """The port's and the JAX tool's proposal files of the C4 Faster R-CNN
    preset on the same pkl."""
    ann, imdir, root = dataset
    weights = str(root / "faster.pkl")
    _weights(FASTER, weights)
    common = ["--preset", FASTER, "--weights", weights, "--ann", ann, "--imdir", imdir,
              "--fp32"]
    with pytest.MonkeyPatch.context() as mp:
        _small(mp, jax_config)
        _small(mp, torch_config)
        spec = importlib.util.spec_from_file_location(
            "jax_make_proposals", os.path.join(REPO, "tools", "make_proposals.py"))
        jax_tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jax_tool)
        mp.setattr(sys, "argv", ["make_proposals.py", *common, "--out", str(root / "jax.pkl")])
        jax_tool.main()
        make_proposals.main([*common, "--out", str(root / "port.pkl"), "--device", "cpu"])
    return str(root / "jax.pkl"), str(root / "port.pkl")


def test_c4_make_proposals_matches_jax_tool(proposals):
    with open(proposals[0], "rb") as f:
        exp = pickle.load(f)
    with open(proposals[1], "rb") as f:
        got = pickle.load(f)
    assert got["ids"] == exp["ids"] and len(got["ids"]) == 3
    for g, e in zip(got["boxes"], exp["boxes"]):
        assert g.dtype == np.float32 and g.shape == e.shape and len(e) > 16
        np.testing.assert_allclose(g, e, rtol=0, atol=3e-3)


def _train(dataset, name, *flags, iters=2):
    ann, imdir, root = dataset
    out = str(root / name)
    proc = subprocess.run(
        [sys.executable, "-m", "detectorch_tpu_torch.tools.train_fast", "--ann", ann,
         "--imdir", imdir, "--out", out, "--max-iter", str(iters), "--checkpoint-period",
         str(iters), "--log-period", "1", "--base-lr", "0.001", "--target-size", "96",
         "--max-size", "128", "--blob", "96", "128", "--rois-per-image", "16",
         "--device", "cpu", *flags],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        # the Tier-1 command's six workers share the cores: one torch thread
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("json_stats") == iters
    return proc.stdout, out


def test_c4_trainer_without_fpn(dataset, proposals):
    """Fast R-CNN C4 from the port's proposals, then e2e Mask R-CNN C4 from
    uint8 input with a producer thread: checkpoints of the C4 params, whose
    res5 head and (e2e) RPN and mask head moved."""
    _, fast_run = _train(dataset, "fast", "--proposals", proposals[1])
    saved = store.restore_checkpoint(os.path.join(fast_run, "ckpt-2"))["params"]
    init = params_from_jax(init_params(torch_config.PRESETS[FAST], seed=3))
    assert set(saved) == set(init) and "fc6_w" not in saved
    for k in ("res5_2_branch2c_w", "cls_score_w", "bbox_pred_w"):
        assert not torch.equal(saved[k], init[k]), k
    out, e2e_run = _train(dataset, "e2e", "--e2e", "--masks", "--device-preprocess",
                          "--prefetch", "2", iters=1)
    assert all(k in out for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_mask"))
    saved = store.restore_checkpoint(os.path.join(e2e_run, "ckpt-1"))["params"]
    init = params_from_jax(init_params(torch_config.PRESETS[MASK], seed=3))
    assert saved["conv5_mask_w"].shape == (2048, 256, 2, 2)
    for k in ("conv_rpn_w", "rpn_cls_logits_w", "conv5_mask_w", "res5_0_branch1_w"):
        assert not torch.equal(saved[k], init[k]), k


def _eval(monkeypatch, dataset, preset, name, *source):
    ann, imdir, root = dataset
    out = str(root / f"{name}.json")
    _small(monkeypatch, torch_config, max_proposals=64, detections_per_img=10)
    eval_coco.main(["--preset", preset, *source, "--ann", ann, "--imdir", imdir, "--out", out,
                    "--fp32", "--exact-blob", "--target-sizes", "96", "--device", "cpu"])
    with open(out) as f:
        return json.load(f)


def test_c4_eval_cli(dataset, proposals, monkeypatch, capsys):
    ann, imdir, root = dataset
    pkl = str(root / "mask.pkl")
    params = _weights(MASK, pkl)
    init_state, _ = make_train_step(torch_config.PRESETS[MASK])
    state, _ = init_state(params)
    store.save_checkpoint(str(root / "mask_run"), 5, state_dict(state))
    res_w = _eval(monkeypatch, dataset, MASK, "weights", "--weights", pkl)
    res_c = _eval(monkeypatch, dataset, MASK, "ckpt", "--ckpt", str(root / "mask_run"))
    assert len(res_w["bbox"]) == len(res_w["segm"]) == 30
    assert res_w == res_c
    res_f = _eval(monkeypatch, dataset, FAST, "fast", "--weights", pkl, "--proposals",
                  proposals[1])
    assert len(res_f["bbox"]) == 30 and not res_f["segm"]
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("box AP: ") for line in lines) == 3
    assert sum(line.startswith("mask AP: ") for line in lines) == 2

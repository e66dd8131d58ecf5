"""The port's proposal tool against the JAX package's ``tools/make_proposals.py``.

Both tools run in this process on the same Detectron pkl (the port's
``save_caffe2_pkl`` of init_params(seed 123)) and the same three synthetic
COCO images, fp32, with a small test configuration patched into each
side's config module: 96x128 images at target size 96 / max size 128 with
ceil-32 padding, RPN 300 -> 64 proposals (the setting of
tests/test_torch_detector.py). Nothing in tools/ changes. The pkls must
hold the same ids, the same number of proposals per image and the boxes in
the same order within 3e-3 px (the backbone's fp32 drift through exp() of
the RPN deltas, as tests/test_torch_detector.py bounds the rois).
"""

import dataclasses
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import detectorch_tpu.config as jax_config
import detectorch_tpu_torch.config as torch_config
from detectorch_tpu.data.synth import build_synth_coco
from detectorch_tpu_torch.checkpoint import caffe2_import as c2
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.models.detector import init_params
from detectorch_tpu_torch.tools import make_proposals

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "e2e_faster_rcnn_R-50-FPN_2x"


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(monkeypatch, config):
    """Patch `config` (either side's config module) to the test's sizes."""
    cfg = config.PRESETS[PRESET]
    monkeypatch.setitem(config.PRESETS, PRESET, cfg.replace(
        rpn=dataclasses.replace(cfg.rpn, pre_nms_top_n=300, post_nms_top_n=64)))
    test_config = config.TestConfig
    monkeypatch.setattr(config, "TestConfig", lambda: test_config(
        target_size=96, max_size=128, exact_blob_dims=True))


def test_make_proposals_matches_jax_tool(tmp_path, monkeypatch, one_torch_thread):
    ann, imdir = build_synth_coco(str(tmp_path / "ds"), n_images=3, height=96, width=128,
                                  seed=12)
    weights = str(tmp_path / "model.pkl")
    cfg = torch_config.PRESETS[PRESET]
    c2.save_caffe2_pkl(params_from_jax(init_params(cfg, seed=123)), cfg, weights)
    _small(monkeypatch, jax_config)
    _small(monkeypatch, torch_config)
    common = ["--preset", PRESET, "--weights", weights, "--ann", ann, "--imdir", imdir,
              "--fp32"]

    spec = importlib.util.spec_from_file_location(
        "jax_make_proposals", os.path.join(REPO, "tools", "make_proposals.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    monkeypatch.setattr(sys, "argv", ["make_proposals.py", *common,
                                      "--out", str(tmp_path / "jax.pkl")])
    jax_tool.main()
    make_proposals.main([*common, "--out", str(tmp_path / "port.pkl"), "--device", "cpu"])

    with open(tmp_path / "jax.pkl", "rb") as f:
        exp = pickle.load(f)
    with open(tmp_path / "port.pkl", "rb") as f:
        got = pickle.load(f)
    assert got["ids"] == exp["ids"] and len(got["ids"]) == 3
    for g, e in zip(got["boxes"], exp["boxes"]):
        assert g.dtype == np.float32 and g.shape == e.shape and len(e) > 16
        np.testing.assert_allclose(g, e, rtol=0, atol=3e-3)

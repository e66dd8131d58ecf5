"""The port's caffe2 ``.pkl`` loader against the JAX package's importer.

A pkl written by the JAX package's ``save_caffe2_pkl`` (Detectron's layout:
OIHW convs, BGR conv1, (C, H, W)-major fc6) must load through the port's
``load_caffe2_pkl`` + ``import_params`` + ``fold_bn`` into exactly the
tensors that ``params_from_jax`` makes of JAX's ``import_params`` +
``fold_bn``: bit for bit, since both only move and multiply the same fp32
values once.
"""

import pickle

import numpy as np
import pytest
import torch

from detectorch_tpu.checkpoint import caffe2_import as jc2
from detectorch_tpu.config import PRESETS
from detectorch_tpu.models import resnet as jresnet
from detectorch_tpu.models.detector import init_params as jax_init_params
from detectorch_tpu_torch.checkpoint import caffe2_import as c2
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from tests.torch_configs import both_configs


def _perturbed_jax_params(cfg, seed):
    """JAX init_params with BN scales and biases away from (1, 0), so that
    folding changes every conv weight."""
    rng = np.random.RandomState(seed)
    params = {k: np.asarray(v) for k, v in jax_init_params(cfg, seed=seed).items()}
    for k in params:
        if k.endswith("_bn_s"):
            params[k] = rng.uniform(0.5, 1.5, params[k].shape).astype(np.float32)
        elif k.endswith("_bn_b"):
            params[k] = (rng.randn(*params[k].shape) * 0.05).astype(np.float32)
    return params


def _assert_equal(got, exp):
    assert set(got) == set(exp)
    for k in exp:
        assert got[k].dtype == torch.float32 and got[k].shape == exp[k].shape, k
        assert torch.equal(got[k], exp[k]), k


MASK_PRESET = "e2e_mask_rcnn_R-50-FPN_2x"
_, PCFG = both_configs(lambda c: c.PRESETS[MASK_PRESET])  # the port's, for the port's loader


@pytest.fixture(scope="module")
def jax_pkl(tmp_path_factory):
    """One full-width mask-preset pkl written by the JAX package, shared by
    this file's tests. The mask preset holds every blob kind the loader
    transforms: conv1, fc6, the mask deconv and the backbone's OIHW convs."""
    cfg = PRESETS[MASK_PRESET]
    jparams = _perturbed_jax_params(cfg, 7)
    path = str(tmp_path_factory.mktemp("caffe2") / "model.pkl")
    jc2.save_caffe2_pkl(jparams, cfg, path)
    return cfg, jparams, path, jc2.import_params(jc2.load_caffe2_pkl(path), cfg)


@pytest.mark.parametrize("folded", [True, False], ids=["folded", "unfolded"])
def test_jax_pkl_loads_bit_for_bit(folded, jax_pkl):
    _, _, path, jimported = jax_pkl
    blobs = c2.load_caffe2_pkl(path)
    assert blobs["conv1_w"].shape == (64, 3, 7, 7)  # caffe2's OIHW
    got, exp = c2.import_params(blobs, PCFG), jimported
    if folded:
        got, exp = c2.fold_bn(got), jc2.fold_bn(exp)
    _assert_equal(got, params_from_jax(exp))


def test_port_round_trip(jax_pkl, tmp_path):
    cfg, jparams, _, _ = jax_pkl
    params = params_from_jax(jparams)
    path = str(tmp_path / "rt.pkl")
    c2.save_caffe2_pkl(params, PCFG, path)
    # the port writes what the JAX package writes
    jax_blobs = jc2.export_to_caffe2_layout(jparams, cfg)
    blobs = c2.load_caffe2_pkl(path)
    assert set(blobs) == set(jax_blobs)
    for k in jax_blobs:
        assert np.array_equal(blobs[k], jax_blobs[k]), k
    _assert_equal(c2.import_params(blobs, PCFG), params)


def test_import_base_cnn_matches_jax():
    jparams = jresnet.init_resnet_params("resnet50", include_c5=True, seed=2)
    blobs = jc2.export_to_caffe2_layout(jparams, PRESETS["fast_rcnn_R-50-FPN_2x"])
    blobs["fc6_w"] = np.zeros((1024, 12544), np.float32)  # heads are not read
    got = c2.import_base_cnn(blobs, "resnet50")
    _assert_equal(got, params_from_jax(jc2.import_base_cnn(blobs, "resnet50")))
    del blobs["res4_2_branch2b_w"]
    with pytest.raises(KeyError):
        c2.import_base_cnn(blobs, "resnet50")


def test_missing_blob_strict_and_momentum(jax_pkl, tmp_path):
    # a training snapshot's _momentum blobs are dropped on load
    snap = str(tmp_path / "m.pkl")
    w = np.ones((2, 3), np.float32)
    with open(snap, "wb") as f:
        pickle.dump({"blobs": {"cls_score_w": w, "cls_score_w_momentum": 0 * w}}, f, protocol=2)
    assert set(c2.load_caffe2_pkl(snap)) == {"cls_score_w"}

    _, _, path, _ = jax_pkl
    loaded = c2.load_caffe2_pkl(path)
    del loaded["cls_score_w"]
    with pytest.raises(KeyError):
        c2.import_params(loaded, PCFG)
    lenient = c2.import_params(loaded, PCFG, strict=False)
    assert lenient["cls_score_w"].shape == (81, 1024)
    loaded["bbox_pred_w"] = loaded["bbox_pred_w"][:10]
    with pytest.raises(ValueError):
        c2.import_params(loaded, PCFG, strict=False)

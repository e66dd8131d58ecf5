"""The port's parameters and network modules against the JAX package.

Both packages get the same weights: the JAX package's numpy blobs, bridged
to the port by ``checkpoint.convert.params_from_jax``. Widths are the full
ResNet-50 / FPN / head widths; only the input is small (64x96).

Tolerance: max |port - jax| <= 1e-4 * max |jax| per output, in fp32. Both
sides compute the same fp32 convolutions and matmuls with other
accumulation orders (oneDNN against XLA:CPU); over the 50+ layers of the
backbone that drifts by ~1e-6 of the output's scale, and an error in
geometry (padding, stride placement, flatten order) moves it by O(1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.config import PRESETS
from detectorch_tpu.models import detector as jdet
from detectorch_tpu.models import fpn as jfpn
from detectorch_tpu.models import heads as jheads
from detectorch_tpu.models import resnet as jresnet
from detectorch_tpu.models import rpn as jrpn
from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_jax
from detectorch_tpu_torch.models import detector as tdet
from detectorch_tpu_torch.models import fpn as tfpn
from detectorch_tpu_torch.models import heads as theads
from detectorch_tpu_torch.models import resnet as tresnet
from detectorch_tpu_torch.models import rpn as trpn
from tests.torch_configs import both_configs

REL = 1e-4
PRESET = "e2e_mask_rcnn_R-50-FPN_2x"


def _close(got, exp, rel=REL):
    exp = np.asarray(exp, np.float32)
    got = got.float().numpy()
    assert got.shape == exp.shape
    scale = np.abs(exp).max()
    assert scale > 0
    err = np.abs(got - exp).max()
    assert err <= rel * scale, f"max err {err} > {rel} * {scale}"


@pytest.fixture(scope="module")
def params():
    """The preset's JAX blobs with every BN scale, BN bias and conv bias
    redrawn: the init's zero branch2c scales and zero biases would hide
    whole branches from the comparison."""
    p = dict(jdet.init_params(PRESETS[PRESET], seed=7))
    rng = np.random.RandomState(11)
    for name, v in p.items():
        if name.endswith("_bn_s"):
            p[name] = rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
        elif name.endswith("_bn_b") or name.endswith("_b"):
            p[name] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return p, params_from_jax(p)


def test_init_params_equal_blob_for_blob():
    cfg, pcfg = both_configs(lambda c: c.PRESETS[PRESET])
    exp = jdet.init_params(cfg, seed=0)
    got = tdet.init_params(pcfg, seed=0)
    assert list(got) == list(exp)
    for name in exp:
        e = np.asarray(exp[name])
        assert got[name].dtype == e.dtype and got[name].shape == e.shape, name
        np.testing.assert_array_equal(got[name], e, err_msg=name)
    # the random network's residual branches start closed
    assert not got["res3_2_branch2c_bn_s"].any()


def test_params_bridge_layouts_and_round_trip(params):
    jp, tp = params
    assert tp["conv1_w"].shape == (64, 3, 7, 7)                  # HWIO -> OIHW
    assert tp["conv_rpn_fpn2_w"].shape == (256, 256, 3, 3)
    assert tp["conv5_mask_w"].shape == jp["conv5_mask_w"].shape  # deconv as is
    assert tp["fc6_w"].shape == (1024, 7 * 7 * 256)              # fc as is
    back = params_to_jax(tp)
    assert back.keys() == jp.keys()
    for name, v in jp.items():
        np.testing.assert_array_equal(back[name], v, err_msg=name)


def test_multilevel_body(params, rng):
    jp, tp = params
    x = (rng.randn(2, 64, 96, 3) * 20).astype(np.float32)
    got = tresnet.multilevel_body(tp, torch.from_numpy(x))
    exp = jresnet.multilevel_body(jp, jnp.asarray(x))
    for k in ("c2", "c3", "c4", "c5"):
        _close(got[k], exp[k])


def test_multilevel_body_fused(params, rng):
    """With grad mode off the trunk runs fused (each BN scale folded into its
    conv's weight, bias, shortcut and relu in one epilogue): held to JAX as
    the unfused trunk is."""
    jp, tp = params
    x = (rng.randn(2, 64, 96, 3) * 20).astype(np.float32)
    with torch.inference_mode():
        got = tresnet.multilevel_body(tp, torch.from_numpy(x))
    exp = jresnet.multilevel_body(jp, jnp.asarray(x))
    for k in ("c2", "c3", "c4", "c5"):
        _close(got[k], exp[k])


def test_stem_max_pool_pads_with_neg_inf(rng):
    # all-negative input: a zero-padded max pool would put 0 on the border
    x = -np.abs(rng.randn(1, 9, 11, 4)).astype(np.float32) - 1.0
    got = tresnet.to_nhwc(tresnet.max_pool_3x3s2(tresnet.to_nchw(torch.from_numpy(x))))
    exp = jresnet.max_pool_3x3s2(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert (got < 0).all()


def test_fpn_neck(params, rng):
    jp, tp = params
    shapes = {"c2": (16, 24, 256), "c3": (8, 12, 512), "c4": (4, 6, 1024), "c5": (2, 3, 2048)}
    feats = {k: rng.randn(2, *s).astype(np.float32) for k, s in shapes.items()}
    got = tfpn.fpn_neck(tp, {k: torch.from_numpy(v) for k, v in feats.items()})
    exp = jfpn.fpn_neck(jp, {k: jnp.asarray(v) for k, v in feats.items()})
    assert len(got) == len(exp) == 4
    for g, e in zip(got, exp):
        _close(g, e)
    _close(tfpn.subsample2x(got[-1]), jfpn.subsample2x(exp[-1]))
    _close(tfpn.upsample2x_nearest(got[-1]), jfpn.upsample2x_nearest(exp[-1]))


def test_fpn_neck_fused(params, rng):
    """With grad mode off each neck conv's bias is added by the epilogue."""
    jp, tp = params
    shapes = {"c2": (16, 24, 256), "c3": (8, 12, 512), "c4": (4, 6, 1024), "c5": (2, 3, 2048)}
    feats = {k: rng.randn(2, *s).astype(np.float32) for k, s in shapes.items()}
    with torch.inference_mode():
        got = tfpn.fpn_neck(tp, {k: torch.from_numpy(v) for k, v in feats.items()})
    exp = jfpn.fpn_neck(jp, {k: jnp.asarray(v) for k, v in feats.items()})
    for g, e in zip(got, exp):
        _close(g, e)


def test_rpn_head(params, rng):
    jp, tp = params
    x = rng.randn(2, 16, 24, 256).astype(np.float32)
    got = trpn.rpn_head(tp, torch.from_numpy(x), prefix="_fpn2")
    exp = jrpn.rpn_head(jp, jnp.asarray(x), prefix="_fpn2")
    for g, e in zip(got, exp):
        assert g.dtype == torch.float32
        _close(g, e)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_box_head_and_predictors(params, rng, dtype):
    # bf16: operands rounded to bf16, fp32 accumulation, fp32 output; a
    # result rounded to bf16 would miss the tolerance by ~40x. Each layer
    # gets the JAX side's input: in bf16, an input an ulp away from a
    # rounding boundary on one side only would flip one operand by a bf16 ulp
    jp, tp = params
    feats = rng.randn(6, 7, 7, 256).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    if dtype == "float32":
        _close(theads.mlp_box_head(tp, torch.from_numpy(feats), tdt),
               jheads.mlp_box_head(jp, jnp.asarray(feats), jdt))
    x = feats.reshape(6, -1)
    for name in ("fc6", "fc7"):
        got = theads.linear(tp, torch.from_numpy(x), name, tdt)
        exp = np.asarray(jheads.linear(jp, jnp.asarray(x), name, jdt))
        assert got.dtype == torch.float32
        _close(got, exp)
        x = np.maximum(exp, 0.0)
    for g, e in zip(theads.box_predictors(tp, torch.from_numpy(x), dtype=tdt),
                    jheads.box_predictors(jp, jnp.asarray(x), dtype=jdt)):
        assert g.dtype == torch.float32
        _close(g, e)


def test_mask_head(params, rng):
    jp, tp = params
    feats = rng.randn(3, 14, 14, 256).astype(np.float32)
    got = theads.mask_head(tp, torch.from_numpy(feats), "1up4convs")
    exp = jheads.mask_head(jp, jnp.asarray(feats), "1up4convs")
    assert got.shape == (3, 28, 28, 81) and got.dtype == torch.float32
    _close(got, exp)
    # the C4 'upshare' head: res5 (the fixture's blobs) on 1024 channels,
    # then conv5_mask over 2048
    up = {**jp, **jheads.init_mask_head_params("upshare", 81, seed=4)}
    rng2 = np.random.RandomState(12)
    up["conv5_mask_b"] = (rng2.randn(256) * 0.1).astype(np.float32)
    feats = rng2.randn(3, 14, 14, 1024).astype(np.float32)
    got = theads.mask_head(params_from_jax(up), torch.from_numpy(feats), "upshare")
    exp = jheads.mask_head(up, jnp.asarray(feats), "upshare")
    assert got.shape == (3, 14, 14, 81) and got.dtype == torch.float32
    _close(got, exp)

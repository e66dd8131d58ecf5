"""The port's Keypoint R-CNN training steps against the JAX package:
``make_train_step`` on host-sampled rois with kp_labels/kp_valid, fp32 and
bf16, and ``make_e2e_train_step(train_keypoints=True)`` with JAX's uniforms
injected (tests/torch_e2e_case.py).

e2e_keypoint_rcnn_R-50-FPN_1x at full R-50-FPN widths with a small
keypoint head (KeypointConfig(num_convs=2, conv_dim=32)), two 64x128
images, one torch thread. The host-sampled batch is tests/test_torch_train's
(24 rois, 6 fg, the person class) with 8 keypoint rows per image: heatmap
bins drawn over the 56x56 grid, valid on fg rows only.
JAX's host-sampled keypoint branch runs its gather RoIAlign; the port's
runs its differentiable RoIAlign, the same function.

Tolerances, as tests/test_torch_train.py and test_torch_e2e_step.py hold
the other presets:
  * fp32 losses and accuracy (loss_kps included): rtol 1e-4, atol 1e-5;
  * fp32 gradients per trainable leaf: max|d| <= 1e-3 * max|g| and cosine
    >= 0.9999, one output channel of a leaf allowed 1e-2 (a ReLU unit
    within rounding of zero; the keypoint trunk's convs add ReLUs, but no
    leaf needs the rule in this case: measured, the worst leaf is
    kps_score_lowres_b at 5.8e-6 of its scale, the worst trunk leaf
    conv_fcn1_b at 1.2e-6); params after 2 steps the same, plus 3 ulp;
  * bf16: losses rtol 2e-2, gradient cosine >= 0.99 per leaf;
  * e2e: the step-0 sample equal row for row (rois within 2e-3 px), the
    keypoint labels and valid flags of the sampled rows exactly JAX's,
    losses rtol 1e-4, gradients and params after 2 steps within 1e-3 of
    each leaf's norm, cosine >= 0.9999.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.train import e2e as JE
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.train import e2e as E
from tests import torch_e2e_case as case
from tests.test_torch_e2e_step import check_gradients, check_params, check_sample
from tests.test_torch_train import (
    _batch,
    _compare_leaf,
    _params,
    _run_jax,
    _run_port,
    _torch_batch,
)
from tests.torch_configs import both_configs

KP = "e2e_keypoint_rcnn_R-50-FPN_1x"
RK, P, S = 8, 17, 56


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kp_cfgs(preset=KP, **kw):
    """(JAX's, the port's) config of `preset` with the small keypoint head."""
    return both_configs(lambda c: c.PRESETS[preset].replace(
        keypoint=c.KeypointConfig(num_convs=2, conv_dim=32), **kw))


def kp_batch(seed, num_classes):
    """tests/test_torch_train's host-sampled batch with kp_labels (B, RK, P)
    heatmap bins and kp_valid on the fg rows only."""
    batch = _batch(seed, num_classes, False)
    rng = np.random.RandomState(seed + 100)
    b = batch["labels"].shape[0]
    batch["kp_labels"] = rng.randint(0, S * S, (b, RK, P)).astype(np.int32)
    batch["kp_valid"] = (rng.rand(b, RK, P) < 0.8) & (batch["labels"][:, :RK, None] > 0)
    return batch


@pytest.fixture(scope="module")
def fp32_run():
    cfg, pcfg = kp_cfgs(compute_dtype="float32")
    params = _params(cfg)
    batch = kp_batch(1, cfg.num_classes)
    jax_metrics, jax_grads, jax_params = _run_jax(cfg, params, batch, False, 2)
    port_metrics, port_params = _run_port(pcfg, params, batch, False, 2)
    return dict(cfg=cfg, pcfg=pcfg, params=params, batch=batch, jax_metrics=jax_metrics,
                jax_grads=jax_grads, jax_params=jax_params, port_metrics=port_metrics,
                port_params=port_params, port_grads=port_grads(pcfg, params, batch)[2])


def port_grads(pcfg, params, batch, roi_align_impl="pallas-slab"):
    """The port's per-image losses, metrics and gradient of one host-sampled
    keypoint step (``box_branch_loss`` with kp_labels/kp_valid)."""
    from detectorch_tpu_torch.train.train_step import box_branch_loss, make_train_step

    from tests.test_torch_train import PSOLVER

    init_state, _ = make_train_step(pcfg, PSOLVER, roi_align_impl=roi_align_impl)
    state, _ = init_state(params_from_jax(params))
    tb = _torch_batch(batch)
    total, metrics = box_branch_loss(
        state.params, pcfg, tb["image"], tb["rois"], tb["labels"], tb["bbox_targets"],
        tb["bbox_inside_weights"], tb["bbox_outside_weights"], tb["valid"],
        kp_labels=tb["kp_labels"], kp_valid=tb["kp_valid"])
    total.mean().backward()
    return total.detach(), metrics, {
        k: (v.grad if v.grad is not None else torch.zeros_like(v))
        for k, v in state.params.items() if v.requires_grad}


def test_kp_step_losses_match_jax(fp32_run):
    keys = ["loss", "loss_cls", "loss_bbox", "loss_kps", "accuracy", "lr"]
    for got, exp in zip(fp32_run["port_metrics"], fp32_run["jax_metrics"]):
        for k in keys:
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=1e-5, err_msg=k)
    first = fp32_run["jax_metrics"][0]
    assert first["loss_kps"] > 1.0 and first["loss_bbox"] > 0.01


def test_kp_step_gradients_match_jax(fp32_run):
    got, exp = fp32_run["port_grads"], fp32_run["jax_grads"]
    trainable = {k for k in exp if not (k.endswith("_bn_s") or k.endswith("_bn_b")
                                        or k.startswith(("conv1", "res_conv1", "res2")))}
    assert set(got) == trainable
    for k in sorted(trainable):
        _compare_leaf(k, got[k].numpy(), exp[k].numpy(), 1e-3, 0.9999)
    for k in ("conv_fcn1_w", "conv_fcn2_w", "kps_score_lowres_w", "kps_score_lowres_b",
              "fpn_res2_2_sum_w", "fc6_w"):
        assert exp[k].abs().max() > 0, k  # the keypoint loss reaches the head and the FPN


def test_kp_params_after_two_steps_match_jax(fp32_run):
    p0 = params_from_jax(fp32_run["params"])
    got, exp = fp32_run["port_params"], fp32_run["jax_params"]
    assert set(got) == set(exp)
    for k in sorted(exp):
        if k in fp32_run["port_grads"]:
            ulps = 3 * np.spacing(p0[k].abs().max().numpy())
            _compare_leaf(k, (got[k] - p0[k]).numpy(), (exp[k] - p0[k]).numpy(), 1e-3, 0.9999,
                          floor=ulps)
        else:  # frozen
            assert torch.equal(got[k], p0[k]) and torch.equal(exp[k], p0[k]), k


def test_kp_bf16_step_matches_jax_bf16():
    cfg, pcfg = kp_cfgs()
    assert cfg.compute_dtype == pcfg.compute_dtype == "bfloat16"
    params = _params(cfg)
    batch = kp_batch(2, cfg.num_classes)
    jax_metrics, jax_grads, _ = _run_jax(cfg, params, batch, False, 1)
    total, metrics, grads = port_grads(pcfg, params, batch)
    for k in ("loss_cls", "loss_bbox", "loss_kps"):
        np.testing.assert_allclose(float(metrics[k].detach().mean()), jax_metrics[0][k],
                                   rtol=2e-2, err_msg=k)
    np.testing.assert_allclose(float(total.mean()), jax_metrics[0]["loss"], rtol=2e-2)
    for k in ("conv_fcn1_w", "conv_fcn2_w", "kps_score_lowres_w", "fc6_w", "fpn_res3_3_sum_w"):
        a = grads[k].numpy().astype(np.float64).ravel()
        e = jax_grads[k].numpy().astype(np.float64).ravel()
        assert a @ e / (np.linalg.norm(a) * np.linalg.norm(e)) >= 0.99, k


@pytest.fixture(scope="module")
def e2e_run():
    cfg, pcfg = kp_cfgs(compute_dtype="float32")
    params = _params(cfg)
    batch = case.make_batch(1, False, False, keypoints=P)
    batch["gt_classes"] = (batch["gt_classes"] > 0).astype(np.int32)  # the person class
    jax_metrics, jax_grads, jax_params = case.run_jax(cfg, params, batch, False, False, 2,
                                                      train_keypoints=True)
    port_metrics, port_params = case.run_port(pcfg, params, batch, False, False, 2,
                                              train_keypoints=True)
    _, _, sampled, port_grads_, images = case.port_losses(pcfg, params, batch, False, False,
                                                          train_keypoints=True)
    return dict(cfg=cfg, params=params, batch=batch, train_mask=False,
                jax_metrics=jax_metrics, jax_grads=jax_grads, jax_params=jax_params,
                port_metrics=port_metrics, port_params=port_params, port_grads=port_grads_,
                sampled=sampled, jax_sampled=case.jax_sampled(cfg, params, images, batch))


def test_kp_e2e_sample_and_labels_match_jax(e2e_run):
    """The sampled rows equal JAX's; on JAX's own rows, the port's keypoint
    labels and valid flags equal JAX's keypoint_labels_device exactly."""
    check_sample(e2e_run)
    fg_rows = 8  # round(0.25 * 32)
    batch = e2e_run["batch"]
    for i, e in enumerate(e2e_run["jax_sampled"]):
        kps = batch["gt_keypoints"][i][e.gt_inds[:fg_rows]]
        jl, jv = map(np.asarray, JE.keypoint_labels_device(jnp.asarray(kps),
                                                           jnp.asarray(e.rois[:fg_rows]), S))
        tl, tv = E.keypoint_labels_device(torch.from_numpy(kps),
                                          torch.from_numpy(e.rois[:fg_rows]), S)
        np.testing.assert_array_equal(tl.numpy(), jl)
        np.testing.assert_array_equal(tv.numpy(), jv)
        assert jv[e.labels[:fg_rows] > 0].any()


def test_kp_e2e_losses_match_jax(e2e_run):
    keys = ["loss", "loss_cls", "loss_bbox", "loss_rpn_cls", "loss_rpn_bbox", "loss_kps",
            "accuracy", "lr"]
    for got, exp in zip(e2e_run["port_metrics"], e2e_run["jax_metrics"]):
        for k in keys:
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert e2e_run["jax_metrics"][0]["loss_kps"] > 1.0


def test_kp_e2e_gradients_and_params_match_jax(e2e_run):
    check_gradients(e2e_run)
    for k in ("conv_fcn1_w", "kps_score_lowres_w"):
        assert e2e_run["jax_grads"][k].abs().max() > 0, k
    check_params(e2e_run)


# --- the keypoint cases of tests/test_torch_train.py's refusal tests ------


def _compact(batch, num_classes):
    """The (B, R, 5) [cls, tx, ty, tw, th] form of a host batch's expanded
    targets."""
    labels = batch["labels"]
    t = batch["bbox_targets"].reshape(*labels.shape, num_classes, 4)
    deltas = np.take_along_axis(t, labels[..., None, None].astype(np.int64), axis=2)[..., 0, :]
    return np.concatenate([labels[..., None].astype(np.float32), deltas], -1)


def uint8_step_matches_jax():
    """The host-sampled keypoint step in the uint8 schema (raw pixels,
    resize tables and meta resized on the device, compact targets) against
    JAX's make_train_step(device_input=True), fp32: the losses rtol 1e-4,
    params after the step within the gradient rule above."""
    cfg, pcfg = kp_cfgs(compute_dtype="float32")
    params = _params(cfg)
    host = kp_batch(3, cfg.num_classes)
    batch = {k: v for k, v in case.make_batch(3, False, True).items()
             if k in ("raw", "tables", "meta")}
    batch.update({k: host[k] for k in ("rois", "labels", "valid", "kp_labels", "kp_valid")})
    batch["bbox_targets_compact"] = _compact(host, cfg.num_classes)
    kw = dict(device_input=True, blob_hw=(case.H, case.W))
    jax_metrics, _, jax_params = _run_jax(cfg, params, batch, False, 1, **kw)
    port_metrics, port_params = _run_port(pcfg, params, batch, False, 1, **kw)
    for got, exp in zip(port_metrics, jax_metrics):
        for k in ("loss", "loss_cls", "loss_bbox", "loss_kps", "accuracy"):
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert jax_metrics[0]["loss_kps"] > 1.0
    p0 = params_from_jax(params)
    for k in ("conv_fcn1_w", "conv_fcn2_w", "kps_score_lowres_w", "fc6_w", "fpn_res3_3_sum_w"):
        ulps = 3 * np.spacing(p0[k].abs().max().numpy())
        _compare_leaf(k, (port_params[k] - p0[k]).numpy(), (jax_params[k] - p0[k]).numpy(),
                      1e-3, 0.9999, floor=ulps)


def c4_step_matches_jax(preset):
    """The host-sampled step of a C4 preset given a keypoint config: the
    keypoint branch on the c4 map (RoIAlign 14x14 at 1/16, the adaptive
    grid) beside the res5 box head, against JAX's step, fp32, one step:
    losses rtol 1e-4, gradients by the rule above (no leaf needs its
    one-channel allowance: measured, the worst is res5_2_branch2c_w at
    7.3e-5 of its scale). The batch is tests/test_torch_c4_train's (16
    rois, 5 fg) with 6 keypoint rows."""
    from tests import test_torch_c4_train as c4t

    cfg, pcfg = kp_cfgs(preset, compute_dtype="float32")
    params = _params(cfg)
    batch = c4t._batch(1, cfg.num_classes, False)
    rng = np.random.RandomState(101)
    batch["kp_labels"] = rng.randint(0, S * S, (2, 6, P)).astype(np.int32)
    batch["kp_valid"] = (rng.rand(2, 6, P) < 0.8) & (batch["labels"][:, :6, None] > 0)
    jax_metrics, jax_grads, _ = c4t._run_jax(cfg, params, batch, False, 1)
    total, metrics, grads = port_grads(pcfg, params, batch, roi_align_impl="gather")
    for k in ("loss_cls", "loss_bbox", "loss_kps"):
        np.testing.assert_allclose(float(metrics[k].detach().mean()), jax_metrics[0][k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total.mean()), jax_metrics[0]["loss"], rtol=1e-4)
    assert set(grads) == {k for k in jax_grads if k in grads}
    for k in sorted(grads):
        _compare_leaf(k, grads[k].numpy(), jax_grads[k].numpy(), 1e-3, 0.9999)
    for k in ("conv_fcn1_w", "kps_score_lowres_w", "res4_5_branch2c_w", "res5_2_branch2c_w"):
        assert jax_grads[k].abs().max() > 0, k


def e2e_step_losses_match_jax(train_keypoints=False):
    """make_e2e_train_step on the keypoint preset, fp32, against JAX's:
    without train_keypoints (no keypoint loss; the keypoint head gets no
    gradient) in the host-blob schema, with it in the uint8 schema. The
    losses rtol 1e-4; the keypoint head's params after the step by the
    gradient rule above (unmoved but for weight decay without it)."""
    cfg, pcfg = kp_cfgs(compute_dtype="float32")
    params = _params(cfg)
    device_input = train_keypoints
    batch = case.make_batch(4, False, device_input, keypoints=P if train_keypoints else 0)
    batch["gt_classes"] = (batch["gt_classes"] > 0).astype(np.int32)  # the person class
    # the keypoint loss of random weights lifts the step-0 gradient past the
    # clip (35): without it JAX's optax trace holds the gradient
    jax_metrics, _, jax_params = case.run_jax(cfg, params, batch, False, device_input, 1,
                                              solver=case.SOLVER_NO_CLIP,
                                              train_keypoints=train_keypoints)
    port_metrics, port_params = case.run_port(pcfg, params, batch, False, device_input, 1,
                                              solver=case.PSOLVER_NO_CLIP,
                                              train_keypoints=train_keypoints)
    keys = ["loss", "loss_cls", "loss_bbox", "loss_rpn_cls", "loss_rpn_bbox", "accuracy"]
    assert ("loss_kps" in port_metrics[0]) == train_keypoints == ("loss_kps" in jax_metrics[0])
    for got, exp in zip(port_metrics, jax_metrics):
        for k in keys + (["loss_kps"] if train_keypoints else []):
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=1e-5, err_msg=k)
    p0 = params_from_jax(params)
    for k in ("conv_fcn1_w", "kps_score_lowres_w", "fc6_w"):
        ulps = 3 * np.spacing(p0[k].abs().max().numpy())
        _compare_leaf(k, (port_params[k] - p0[k]).numpy(), (jax_params[k] - p0[k]).numpy(),
                      1e-3, 0.9999, floor=ulps)

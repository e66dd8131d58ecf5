"""The port's training step against JAX's ``make_train_step``.

Both steps get the same weights (the JAX package's blobs, bridged by
``checkpoint.convert.params_from_jax``) and the same numpy batch: two
64x128 images at full R-50-FPN widths, 24 rois each spread over P2..P5
(some partly outside the image, padded rows marked invalid), fg rows with
box targets, and for Mask R-CNN 8 mask rows per image. The JAX step runs
with ``roi_align_impl='pallas-slab'``: the Pallas forward and the slab
backward in interpret mode for the box branch, the gather RoIAlign for the
mask branch. JAX's gradient is read from the optax trace after one step
(trace = g + wd * p0 while the clip is idle, which the test checks).

Tolerances, fp32 compute:
  * losses and accuracy: rtol 1e-4, atol 1e-5;
  * every trainable leaf's gradient: max|d| <= 1e-3 * max|g_leaf| and
    cosine >= 0.9999, except that one output channel of a leaf may reach
    1e-2 (a ReLU unit within rounding of zero; see _compare_leaf); params
    after 3 steps: the same bounds on p3 - p0, plus 3 ulp of the leaf's
    largest value for the fp32 rounding of the stored params at each step;
    frozen leaves do not move. Both sides run the same fp32 convolutions,
    matmuls and RoIAlign sums in other orders (oneDNN against XLA:CPU,
    scatter against per-roi matmuls); through the backbone's backward that
    drifts by ~1e-5 of a leaf's scale (measured: at most 1.1e-4 outside
    that one channel), an error in a rule by O(1).
bf16 compute: losses rtol 2e-2 and gradient cosine >= 0.99 per leaf with
a non-zero gradient: the two frameworks round activations to bf16 at other
places.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from detectorch_tpu.models.detector import init_params
from detectorch_tpu.train.sampler import expand_bbox_targets
from detectorch_tpu.train.train_step import make_train_step as jax_make_train_step
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.config import PRESETS
from detectorch_tpu_torch.train.e2e import make_e2e_train_step
from detectorch_tpu_torch.train.train_step import box_branch_loss, make_train_step
from tests.torch_configs import both_configs

# JAX's solver and the port's, each from its own package
SOLVER, PSOLVER = both_configs(lambda c: c.SolverConfig(base_lr=0.01, warmup_iters=0))


def _cfgs(preset, **kw):
    """(JAX's, the port's) config of `preset` with `kw` replaced."""
    return both_configs(lambda c: c.PRESETS[preset].replace(**kw))
FAST, MASK = "fast_rcnn_R-50-FPN_2x", "e2e_mask_rcnn_R-50-FPN_2x"
B, R, RM = 2, 24, 8


def _params(cfg):
    """The preset's blobs with BN scales and biases redrawn: the init's zero
    branch2c scales would cut every residual branch out of the gradient."""
    p = {k: np.asarray(v) for k, v in init_params(cfg, seed=0).items()}
    rng = np.random.RandomState(11)
    for name, v in p.items():
        if name.endswith("_bn_s"):
            p[name] = rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
        elif name.endswith("_bn_b") or name.endswith("_b"):
            p[name] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return p


def _batch(seed, num_classes, mask):
    rng = np.random.RandomState(seed)
    h, w = 64, 128
    side = np.exp(rng.uniform(np.log(12), np.log(700), (B, R)))  # P2..P5
    aspect = np.exp(rng.uniform(-1, 1, (B, R)))
    cx, cy = rng.uniform(0, w, (B, R)), rng.uniform(0, h, (B, R))
    bw, bh = side * np.sqrt(aspect), side / np.sqrt(aspect)
    rois = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1).astype(np.float32)
    labels = np.zeros((B, R), np.int32)
    labels[:, :6] = rng.randint(1, num_classes, (B, 6))
    compact = np.concatenate([labels[..., None], rng.randn(B, R, 4) * 0.5], -1)
    targets, inside = zip(*[expand_bbox_targets(c.astype(np.float32), num_classes)
                            for c in compact])
    valid = np.ones((B, R), bool)
    valid[:, -3:] = False
    batch = {
        "image": (rng.randn(B, h, w, 3) * 30).astype(np.float32),
        "rois": rois, "labels": labels,
        "bbox_targets": np.stack(targets), "bbox_inside_weights": np.stack(inside),
        "bbox_outside_weights": (np.stack(inside) > 0).astype(np.float32),
        "valid": valid,
    }
    if mask:
        # filled ellipses, as object masks are: random 0/1 pixels would make
        # the mask head's gradients sums of cancelling terms
        yy, xx = np.mgrid[:28, :28] - 13.5
        ry, rx = rng.uniform(6, 14, (2, B, RM, 1, 1))
        batch["mask_targets"] = ((yy / ry) ** 2 + (xx / rx) ** 2 <= 1).astype(np.float32)
        batch["mask_valid"] = np.arange(RM)[None].repeat(B, 0) < 6
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_trace(opt_state):
    states = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
    (trace,) = [s.trace for s in states if isinstance(s, optax.TraceState)]
    return trace


def _run_jax(cfg, params, batch, train_mask, steps):
    """Metrics of each step, JAX's gradient at step 1 and params after
    `steps` steps (both in the port's layout)."""
    init_state, make_step = jax_make_train_step(cfg, SOLVER, train_mask=train_mask,
                                                roi_align_impl="pallas-slab")
    state, tx = init_state(params)
    step = jax.jit(make_step(tx))
    metrics, grads = [], None
    for i in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            trace = _jax_trace(state.opt_state)
            wd = np.float32(SOLVER.weight_decay)
            grads = {k: np.array(trace[k]) - wd * params[k] for k in params}
            norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
            assert norm < SOLVER.clip_grad_norm  # the trace holds the unclipped gradient
    params = params_from_jax({k: np.array(v) for k, v in state.params.items()})
    return metrics, params_from_jax(grads), params


def _port_grads(cfg, params, batch, train_mask):
    init_state, _ = make_train_step(cfg, PSOLVER, train_mask=train_mask,
                                    roi_align_impl="pallas-slab")
    state, _ = init_state(params_from_jax(params))
    tb = _torch_batch(batch)
    extra = {k: tb[k] for k in ("mask_targets", "mask_valid") if train_mask}
    total, metrics = box_branch_loss(
        state.params, cfg, tb["image"], tb["rois"], tb["labels"], tb["bbox_targets"],
        tb["bbox_inside_weights"], tb["bbox_outside_weights"], tb["valid"], **extra)
    total.mean().backward()
    return total.detach(), metrics, {
        k: (v.grad if v.grad is not None else torch.zeros_like(v))
        for k, v in state.params.items() if v.requires_grad}


def _run_port(cfg, params, batch, train_mask, steps):
    init_state, make_step = make_train_step(cfg, PSOLVER, train_mask=train_mask,
                                            roi_align_impl="pallas-slab")
    state, opt = init_state(params_from_jax(params))
    step = make_step(opt)
    metrics = []
    for _ in range(steps):
        state, m = step(state, _torch_batch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: v.detach() for k, v in state.params.items()}


def _compare_leaf(name, got, exp, rel, cos_min, floor=0.0):
    """Port-layout leaves: cosine >= cos_min, and max|d| <= rel * max|exp| +
    floor on every slice along the leading (output-channel) axis but one,
    which is held to 10 * rel: a ReLU unit whose pre-activation lies within
    fp32 rounding of zero passes on one side only and moves its one channel
    (measured: channel 129 of _[mask]_fcn1_w at 4.7e-3 of the leaf's max,
    the next channel at 2.5e-5)."""
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    scale = np.abs(exp).max()
    if scale == 0:
        assert np.abs(got).max() == 0, name
        return
    per_slice = np.sort(np.abs(got - exp).reshape(len(exp), -1).max(axis=1))
    cos = got.ravel() @ exp.ravel() / (np.linalg.norm(got) * np.linalg.norm(exp))
    worst = per_slice[-2] if len(per_slice) > 1 else 0.0
    assert worst <= rel * scale + floor, (name, worst / scale)
    assert per_slice[-1] <= 10 * rel * scale + floor, (name, per_slice[-1] / scale)
    assert cos >= cos_min, (name, cos)


@pytest.fixture(scope="module", params=[(FAST, False), (MASK, True)], ids=["fast", "mask"])
def fp32_run(request):
    preset, train_mask = request.param
    cfg, pcfg = _cfgs(preset, compute_dtype="float32")
    params = _params(cfg)
    batch = _batch(1, cfg.num_classes, train_mask)
    jax_metrics, jax_grads, jax_params = _run_jax(cfg, params, batch, train_mask, 3)
    port_metrics, port_params = _run_port(pcfg, params, batch, train_mask, 3)
    _, _, port_grads = _port_grads(pcfg, params, batch, train_mask)
    return dict(cfg=cfg, params=params, jax_metrics=jax_metrics, jax_grads=jax_grads,
                jax_params=jax_params, port_metrics=port_metrics, port_params=port_params,
                port_grads=port_grads, train_mask=train_mask)


def test_step_losses_match_jax(fp32_run):
    keys = ["loss", "loss_cls", "loss_bbox", "accuracy", "lr"]
    keys += ["loss_mask"] if fp32_run["train_mask"] else []
    for got, exp in zip(fp32_run["port_metrics"], fp32_run["jax_metrics"]):
        for k in keys:
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=1e-5, err_msg=k)
    first = fp32_run["jax_metrics"][0]
    assert first["loss_bbox"] > 0.01 and (not fp32_run["train_mask"] or first["loss_mask"] > 0.1)


def test_step_gradients_match_jax(fp32_run):
    got, exp = fp32_run["port_grads"], fp32_run["jax_grads"]
    trainable = {k for k, v in exp.items()
                 if not (k.endswith("_bn_s") or k.endswith("_bn_b")
                         or k.startswith(("conv1", "res_conv1", "res2")))}
    assert set(got) == trainable
    nonzero = 0
    for k in sorted(trainable):
        _compare_leaf(k, got[k].numpy(), exp[k].numpy(), 1e-3, 0.9999)
        nonzero += bool(exp[k].abs().max() > 0)
    # the backbone from res3 up, every FPN level's convs and the heads all learn
    assert nonzero >= 0.9 * len(trainable) - (12 if fp32_run["train_mask"] else 0)
    for lvl in ("fpn_res2_2_sum_w", "fpn_res3_3_sum_w", "fpn_res4_5_sum_w",
                "fpn_res5_2_sum_w", "res3_0_branch2a_w"):
        assert exp[lvl].abs().max() > 0, lvl


def test_params_after_three_steps_match_jax(fp32_run):
    p0 = params_from_jax(fp32_run["params"])
    got, exp = fp32_run["port_params"], fp32_run["jax_params"]
    assert set(got) == set(exp)
    for k in sorted(exp):
        if k in fp32_run["port_grads"]:
            # each side rounds p to fp32 at every step: 3 ulp of the leaf's
            # largest value on top of the relative bound (measured: 1 ulp,
            # 1.49e-8 on res4_1_branch2c_w, whose update peaks at 8.3e-6)
            ulps = 3 * np.spacing(p0[k].abs().max().numpy())
            _compare_leaf(k, (got[k] - p0[k]).numpy(), (exp[k] - p0[k]).numpy(), 1e-3, 0.9999,
                          floor=ulps)
        else:  # frozen
            assert torch.equal(got[k], p0[k]) and torch.equal(exp[k], p0[k]), k


def test_bf16_step_matches_jax_bf16():
    cfg, pcfg = _cfgs(FAST)
    assert cfg.compute_dtype == pcfg.compute_dtype == "bfloat16"
    params = _params(cfg)
    batch = _batch(2, cfg.num_classes, False)
    jax_metrics, jax_grads, _ = _run_jax(cfg, params, batch, False, 1)
    total, metrics, port_grads = _port_grads(pcfg, params, batch, False)
    for k in ("loss_cls", "loss_bbox"):
        np.testing.assert_allclose(float(metrics[k].detach().mean()), jax_metrics[0][k],
                                   rtol=2e-2)
    np.testing.assert_allclose(float(total.mean()), jax_metrics[0]["loss"], rtol=2e-2)
    checked = 0
    for k, g in port_grads.items():
        e = jax_grads[k].numpy().astype(np.float64).ravel()
        if np.abs(e).max() == 0:
            continue
        a = g.numpy().astype(np.float64).ravel()
        cos = a @ e / (np.linalg.norm(a) * np.linalg.norm(e))
        assert cos >= 0.99, (k, cos)
        checked += 1
    assert checked >= 50


def test_batch_loss_is_the_mean_of_per_image_losses():
    """The step's loss and gradient are the means over images of each
    image's own loss (each normalised by its own valid rows), as JAX's
    vmapped loss gives — not one loss over the flattened batch. fp32:
    rtol 1e-5 on each image's loss; per leaf, ||d|| <= 5e-3 * ||g|| and
    cosine >= 0.9999 on the gradient. Batched and single-image convolutions
    sum in other orders (oneDNN picks its blocking by batch and thread
    count), and the mask trunk's weight gradients are sums with much
    cancellation: measured at most 1.31e-3 (one thread) and 3.2e-4 (six
    threads), in _[mask]_fcn1_w and _[mask]_fcn2_w. Normalising over the
    flattened batch instead moves both by tens of percent."""
    cfg, pcfg = _cfgs(MASK, compute_dtype="float32")
    params = _params(cfg)
    batch = _batch(3, cfg.num_classes, True)
    batch["valid"][1, 4:] = False  # the two images have other valid counts
    batch["mask_valid"][1, 2:] = False
    total, _, grads = _port_grads(pcfg, params, batch, True)
    singles = [_port_grads(pcfg, params, {k: v[i:i + 1] for k, v in batch.items()}, True)
               for i in range(B)]
    np.testing.assert_allclose(total.numpy(), [float(s[0][0]) for s in singles], rtol=1e-5)
    for k, g in grads.items():
        got = g.double().flatten()
        exp = ((singles[0][2][k] + singles[1][2][k]) / 2).double().flatten()
        if not exp.any():
            assert not got.any(), k
            continue
        assert (got - exp).norm() <= 5e-3 * exp.norm(), k
        assert got @ exp / (got.norm() * exp.norm()) >= 0.9999, k


@pytest.mark.parametrize("preset,kwargs,error", [
    ("e2e_mask_rcnn_R-50-C4_2x", {}, NotImplementedError),
    ("e2e_keypoint_rcnn_R-50-FPN_1x", {}, NotImplementedError),
    (FAST, {"train_mask": True}, ValueError),
    (FAST, {"roi_align_impl": "pallas-mm"}, ValueError),
])
def test_unported_training_raises(preset, kwargs, error):
    with pytest.raises(error):
        make_train_step(PRESETS[preset], PSOLVER, **kwargs)


@pytest.mark.parametrize("preset,kwargs", [
    ("e2e_faster_rcnn_R-50-C4_2x", {}),
    ("e2e_keypoint_rcnn_R-50-FPN_1x", {}),
    ("e2e_keypoint_rcnn_R-50-FPN_1x", {"train_keypoints": True}),
], ids=["C4", "keypoint-preset", "train_keypoints"])
def test_unported_e2e_training_raises(preset, kwargs):
    with pytest.raises(NotImplementedError):
        make_e2e_train_step(PRESETS[preset], PSOLVER, **kwargs)

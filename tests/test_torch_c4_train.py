"""The port's C4 training step against JAX's ``make_train_step``: Fast and
Mask R-CNN R-50-C4 on host-sampled rois (the e2e step:
tests/test_torch_c4_e2e.py).

Host-sampled step: two 64x128 images at full R-50-C4 widths, 16 rois each
(8 to 250 px, some partly outside the image, padded rows invalid), fg rows
with box targets and, for Mask R-CNN, 6 mask rows of 14x14 per image. JAX
runs ``roi_align_impl='gather'`` (its C4 RoIAlign is the separable
``roi_align_matmul``, whatever the name); the port's CPU tensors run its
plain separable form, the same function.

Tolerances, as tests/test_torch_train.py: fp32 losses rtol 1e-4, atol
1e-5; gradients per trainable leaf max|d| <= 1e-3 * max|g| (one output
channel 1e-2) and cosine >= 0.9999, the same on the params' change after
two steps; bf16 losses rtol 2e-2 and cosine >= 0.99 per leaf.
"""

import numpy as np
import pytest
import torch

from detectorch_tpu.train.sampler import expand_bbox_targets
from detectorch_tpu.train.train_step import make_train_step as jax_make_train_step
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.train.train_step import box_branch_loss, make_train_step
from tests.test_torch_train import PSOLVER, SOLVER, _cfgs, _compare_leaf, _jax_trace, _params

FAST, MASK = "fast_rcnn_R-50-C4_2x", "e2e_mask_rcnn_R-50-C4_2x"
B, R, RM, M = 2, 16, 6, 14


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, num_classes, mask):
    rng = np.random.RandomState(seed)
    h, w = 64, 128
    side = np.exp(rng.uniform(np.log(8), np.log(250), (B, R)))
    aspect = np.exp(rng.uniform(-1, 1, (B, R)))
    cx, cy = rng.uniform(0, w, (B, R)), rng.uniform(0, h, (B, R))
    bw, bh = side * np.sqrt(aspect), side / np.sqrt(aspect)
    rois = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1).astype(np.float32)
    labels = np.zeros((B, R), np.int32)
    labels[:, :5] = rng.randint(1, num_classes, (B, 5))
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
        yy, xx = np.mgrid[:M, :M] - (M - 1) / 2
        ry, rx = rng.uniform(3, 7, (2, B, RM, 1, 1))
        batch["mask_targets"] = ((yy / ry) ** 2 + (xx / rx) ** 2 <= 1).astype(np.float32)
        batch["mask_valid"] = np.arange(RM)[None].repeat(B, 0) < 5
    return batch


def _run_jax(cfg, params, batch, train_mask, steps):
    init_state, make_step = jax_make_train_step(cfg, SOLVER, train_mask=train_mask)
    state, tx = init_state(params)
    import jax

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


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(cfg, params, batch, train_mask):
    init_state, _ = make_train_step(cfg, PSOLVER, train_mask=train_mask)
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
    init_state, make_step = make_train_step(cfg, PSOLVER, train_mask=train_mask)
    state, opt = init_state(params_from_jax(params))
    step = make_step(opt)
    metrics = []
    for _ in range(steps):
        state, m = step(state, _torch_batch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: v.detach() for k, v in state.params.items()}


@pytest.fixture(scope="module", params=[(FAST, False), (MASK, True)], ids=["fast", "mask"])
def fp32_run(request):
    preset, train_mask = request.param
    cfg, pcfg = _cfgs(preset, compute_dtype="float32")
    params = _params(cfg)
    batch = _batch(1, cfg.num_classes, train_mask)
    jax_metrics, jax_grads, jax_params = _run_jax(cfg, params, batch, train_mask, 2)
    port_metrics, port_params = _run_port(pcfg, params, batch, train_mask, 2)
    _, _, port_grads = _port_grads(pcfg, params, batch, train_mask)
    return dict(params=params, jax_metrics=jax_metrics, jax_grads=jax_grads,
                jax_params=jax_params, port_metrics=port_metrics, port_params=port_params,
                port_grads=port_grads, train_mask=train_mask)


def test_c4_step_losses_match_jax(fp32_run):
    keys = ["loss", "loss_cls", "loss_bbox", "accuracy", "lr"]
    keys += ["loss_mask"] if fp32_run["train_mask"] else []
    for got, exp in zip(fp32_run["port_metrics"], fp32_run["jax_metrics"]):
        for k in keys:
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=1e-5, err_msg=k)
    first = fp32_run["jax_metrics"][0]
    assert first["loss_bbox"] > 0.01 and (not fp32_run["train_mask"] or first["loss_mask"] > 0.1)


def test_c4_step_gradients_and_params_match_jax(fp32_run):
    got, exp = fp32_run["port_grads"], fp32_run["jax_grads"]
    trainable = {k for k in exp
                 if not (k.endswith("_bn_s") or k.endswith("_bn_b")
                         or k.startswith(("conv1", "res_conv1", "res2")))}
    assert set(got) == trainable
    for k in sorted(trainable):
        _compare_leaf(k, got[k].numpy(), exp[k].numpy(), 1e-3, 0.9999)
    # res5 learns through the box head (and the mask head), res3-res4
    # through the RoIAlign gradient into c4
    for k in ("res5_2_branch2c_w", "res4_5_branch2c_w", "res3_0_branch2a_w", "cls_score_w"):
        assert exp[k].abs().max() > 0, k
    p0 = params_from_jax(fp32_run["params"])
    gp, ep = fp32_run["port_params"], fp32_run["jax_params"]
    for k in sorted(ep):
        if k in got:
            ulps = 3 * np.spacing(p0[k].abs().max().numpy())
            _compare_leaf(k, (gp[k] - p0[k]).numpy(), (ep[k] - p0[k]).numpy(), 1e-3, 0.9999,
                          floor=ulps)
        else:
            assert torch.equal(gp[k], p0[k]) and torch.equal(ep[k], p0[k]), k


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.mark.parametrize("preset,train_mask", [(FAST, False), (MASK, True)], ids=["fast", "mask"])
def test_c4_bf16_step_matches_jax_bf16(preset, train_mask):
    """bf16: losses rtol 2e-2; each leaf's gradient within cosine 0.99 of
    JAX's bf16 one. The mask head's bias gradients are sums of
    sigmoid(x) - t that cancel, and JAX's own bf16 gradient there drifts
    from its fp32 one (cosine 0.97 on conv5_mask_b); a leaf where JAX's
    bf16 and fp32 gradients are further apart than cosine 0.99 is held to
    JAX's own drift less 0.01, and to cosine 0.98 with JAX's fp32
    gradient, as tests/test_torch_e2e_input.py holds the e2e mask head."""
    cfg, pcfg = _cfgs(preset)
    assert cfg.compute_dtype == pcfg.compute_dtype == "bfloat16"
    params = _params(cfg)
    batch = _batch(2, cfg.num_classes, train_mask)
    jax_metrics, jax_grads, _ = _run_jax(cfg, params, batch, train_mask, 1)
    _, jax_grads32, _ = _run_jax(_cfgs(preset, compute_dtype="float32")[0], params, batch,
                                 train_mask, 1)
    total, metrics, port_grads = _port_grads(pcfg, params, batch, train_mask)
    for k in ("loss_cls", "loss_bbox") + (("loss_mask",) if train_mask else ()):
        np.testing.assert_allclose(float(metrics[k].detach().mean()), jax_metrics[0][k],
                                   rtol=2e-2, err_msg=k)
    np.testing.assert_allclose(float(total.mean()), jax_metrics[0]["loss"], rtol=2e-2)
    checked = 0
    for k, g in port_grads.items():
        e = jax_grads[k].numpy()
        if np.abs(e).max() == 0:
            continue
        own = _cos(e, jax_grads32[k].numpy())
        if own >= 0.99:
            assert _cos(g.numpy(), e) >= 0.99, (k, _cos(g.numpy(), e))
        else:
            assert _cos(g.numpy(), e) >= own - 0.01, (k, own)
            assert _cos(g.numpy(), jax_grads32[k].numpy()) >= 0.98, k
        checked += 1
    assert checked >= 40  # res3 up, the RPN-free heads

"""The uint8 training input (``device_input=True``) of both training steps
against JAX, the e2e step in bf16, and the e2e step's resume.

  * e2e Mask R-CNN with ``device_input``: raw uint8 images, resize tables
    and meta, resized on the device into the 64x128 bucket, ``info`` from
    meta; the comparisons and tolerances of tests/test_torch_e2e_step.py.
  * ``train_step.make_train_step(device_input=True)``: the Fast R-CNN batch
    of tests/test_torch_train.py with the image as uint8 and compact box
    targets; losses rtol 1e-4, atol 1e-5 at each of two steps, params after
    two steps as tests/test_torch_train.py bounds them.
  * bf16 e2e Mask R-CNN, one step: losses rtol 2e-2 against JAX bf16.
    Per leaf with a non-zero gradient, the port's bf16 gradient is no
    further from JAX's bf16 gradient (in cosine) than JAX's bf16 gradient
    is from JAX's fp32 one, plus 0.01, and within cosine 0.98 of JAX's fp32
    gradient. JAX's bf16 backward rounds the mask head's cancelling sums to
    bf16 (measured: cosine 0.789 between its bf16 and fp32 gradients of
    conv5_mask_b, 0.985 of _[mask]_fcn4_b), where the port's stays within
    0.986 of fp32 on every leaf. The samples are not compared: the
    proposals come out of bf16 convolutions rounded at other places, so the
    two sides keep other background proposals.
  * resume: steps 0-1, a checkpoint, a restore into a fresh state and
    step 2 equal bit for bit to steps 0-2 unbroken, with the default
    ``torch_uniforms`` (seeded from seed, step and image alone).
"""

import jax
import numpy as np
import pytest
import torch

from detectorch_tpu.data.device_input import pack_tables_meta, prepare_raw
from detectorch_tpu.train.train_step import make_train_step as jax_make_train_step
from detectorch_tpu_torch.checkpoint import store
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.train import e2e as E
from detectorch_tpu_torch.train.train_step import load_state_dict, make_train_step, state_dict
from tests import torch_e2e_case as case
from tests.test_torch_e2e_step import (
    MASK,
    check_gradients,
    check_losses,
    check_params,
    check_sample,
    run_case,
)
from tests.test_torch_train import FAST, _batch, _compare_leaf, _params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def device_input_run():
    return run_case(MASK, True, True, seed=2)


def test_e2e_device_input_losses_match_jax(device_input_run):
    check_losses(device_input_run)


def test_e2e_device_input_sample_matches_jax(device_input_run):
    check_sample(device_input_run)


def test_e2e_device_input_gradients_match_jax(device_input_run):
    check_gradients(device_input_run)


def test_e2e_device_input_params_after_two_steps_match_jax(device_input_run):
    check_params(device_input_run)


def _uint8_fast_batch():
    """tests/test_torch_train._batch's Fast R-CNN batch in the uint8 schema:
    two uint8 images of 60x120 and 50x110 resized into the 64x128 bucket,
    compact box targets."""
    batch = _batch(4, 81, False)
    rng = np.random.RandomState(4)
    raws, tables, metas = [], [], []
    for oh, ow in case.ORIG:
        im = rng.randint(0, 256, (oh, ow, 3)).astype(np.uint8)
        raw, m = prepare_raw(im, target_size=64, max_size=128, buckets=((64, 128),),
                             raw_stride=16)
        padded = np.zeros((64, 128, 3), np.uint8)
        padded[: raw.shape[0], : raw.shape[1]] = raw
        t, meta = pack_tables_meta(m)
        raws.append(padded)
        tables.append(t)
        metas.append(meta)
    t = batch["bbox_targets"].reshape(*batch["bbox_targets"].shape[:2], 81, 4).sum(axis=2)
    compact = np.concatenate([batch["labels"][..., None].astype(np.float32), t], -1)
    return {"raw": np.stack(raws), "tables": np.stack(tables), "meta": np.stack(metas),
            "rois": batch["rois"], "labels": batch["labels"], "valid": batch["valid"],
            "bbox_targets_compact": compact}


def test_device_input_train_step_matches_jax():
    cfg, pcfg = case.cfgs(FAST, compute_dtype="float32")
    params = _params(cfg)
    batch = _uint8_fast_batch()
    init_state, make_step = jax_make_train_step(cfg, case.SOLVER, device_input=True,
                                                blob_hw=(64, 128), roi_align_impl="pallas-slab")
    state, tx = init_state(params)
    step = jax.jit(make_step(tx))
    pinit, pmake = make_train_step(pcfg, case.PSOLVER, device_input=True, blob_hw=(64, 128),
                                   roi_align_impl="pallas-slab")
    pstate, opt = pinit(params_from_jax(params))
    pstep = pmake(opt)
    for _ in range(2):
        state, m = step(state, batch)
        pstate, pm = pstep(pstate, case.torch_batch(batch))
        for k in ("loss", "loss_cls", "loss_bbox", "accuracy"):
            np.testing.assert_allclose(float(pm[k]), float(m[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    assert float(m["loss_bbox"]) > 1e-3
    p0 = params_from_jax(params)
    exp = params_from_jax({k: np.array(v) for k, v in state.params.items()})
    moved = 0
    for k, v in pstate.params.items():
        if v.requires_grad:
            ulps = 3 * np.spacing(p0[k].abs().max().numpy())
            _compare_leaf(k, (v.detach() - p0[k]).numpy(), (exp[k] - p0[k]).numpy(), 1e-3,
                          0.9999, floor=ulps)
            moved += 1
    assert moved > 50


def _cos(a, b):
    a, b = a.numpy().astype(np.float64).ravel(), b.numpy().astype(np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def test_e2e_bf16_step_matches_jax_bf16():
    cfg, pcfg = case.cfgs(MASK)
    assert cfg.compute_dtype == pcfg.compute_dtype == "bfloat16"
    cfg32 = case.cfgs(MASK, compute_dtype="float32")[0]
    params = _params(cfg)
    batch = case.make_batch(3, True, False)
    jax_metrics, jax_grads, _ = case.run_jax(cfg, params, batch, True, False, 1)
    _, jax_grads32, _ = case.run_jax(cfg32, params, batch, True, False, 1)
    total, metrics, _, grads, _ = case.port_losses(pcfg, params, batch, True, False)
    for k in ("loss_cls", "loss_bbox", "loss_rpn_cls", "loss_rpn_bbox", "loss_mask"):
        np.testing.assert_allclose(float(metrics[k].detach().mean()), jax_metrics[0][k],
                                   rtol=2e-2, err_msg=k)
    np.testing.assert_allclose(float(total.mean()), jax_metrics[0]["loss"], rtol=2e-2)
    checked = 0
    for k, g in grads.items():
        if not jax_grads[k].numpy().any():
            continue
        assert _cos(g, jax_grads[k]) >= _cos(jax_grads[k], jax_grads32[k]) - 0.01, k
        assert _cos(g, jax_grads32[k]) >= 0.98, k
        checked += 1
    assert checked >= 50


def test_e2e_resume_is_exact(tmp_path):
    _, pcfg = case.cfgs(MASK, compute_dtype="float32")
    params = params_from_jax(_params(case.cfgs(MASK, compute_dtype="float32")[0]))
    batch = case.torch_batch(case.make_batch(5, True, False))
    init_state, make_step = E.make_e2e_train_step(
        pcfg, case.PSOLVER, case.PSAMPLER, seed=9, train_pre_nms=case.PRE,
        train_post_nms=case.POST, train_mask=True)

    straight, opt = init_state(params)
    step = make_step(opt)
    for _ in range(3):
        straight, last = step(straight, batch)

    state, opt = init_state(params)
    step = make_step(opt)
    for _ in range(2):
        state, _ = step(state, batch)
    path = store.save_checkpoint(str(tmp_path), state.step, state_dict(state))
    fresh, opt = init_state(params)
    fresh = load_state_dict(fresh, store.restore_checkpoint(path))
    assert fresh.step == 2
    fresh, resumed = make_step(opt)(fresh, batch)
    assert fresh.step == 3
    assert all(float(resumed[k]) == float(last[k]) for k in last)
    for k, v in straight.params.items():
        assert torch.equal(fresh.params[k], v), k
    # the step's draws depend on the step: step 2's are not step 0's
    draw = E.torch_uniforms(9)
    a, b = draw(0, 2, 10, 6, torch.device("cpu")), draw(2, 2, 10, 6, torch.device("cpu"))
    assert not torch.equal(a["anchor_pos"], b["anchor_pos"])
    assert torch.equal(a["roi_fg"], draw(0, 2, 10, 6, torch.device("cpu"))["roi_fg"])
    assert float(a["roi_order"].max()) < 0.5

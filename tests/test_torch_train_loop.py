"""The port's losses, LR schedule, optimizer, checkpoints and training CLI.

Losses, the schedule and the SGD update are held to the JAX package
(``train/losses.py``, ``train/solver.py`` and its optax chain) on the same
numpy inputs, in fp32: rtol 1e-6 for losses and the schedule (the same
float32 formulas), and for the optimizer rtol 1e-6 with atol 1e-8 on the
params (torch's clip divides by norm + 1e-6 where optax divides by the
norm, and the two round the update once each). Checkpoints must resume
bit for bit: one step, save, restore, one step equals two steps.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.config import PRESETS
from detectorch_tpu.models.detector import init_params
from detectorch_tpu.train import losses as jlosses
from detectorch_tpu.train import solver as jsolver
from detectorch_tpu.train.train_step import expand_bbox_targets_device as jax_expand
from detectorch_tpu_torch.checkpoint import store
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.tools import train_fast
from detectorch_tpu_torch.train import losses, solver
from detectorch_tpu_torch.train.train_step import (
    expand_bbox_targets_device,
    load_state_dict,
    make_train_step,
    state_dict,
)
from tests.torch_configs import both_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy


def _close(got, exp, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(exp, np.float64),
                               rtol=rtol, atol=0)


def test_losses_match_jax(rng):
    b, r, k, m = 3, 16, 81, 28
    logits = (rng.randn(b, r, k) * 3).astype(np.float32)
    labels = rng.randint(0, k, (b, r)).astype(np.int32)
    valid = rng.rand(b, r) > 0.3
    pred, tgt = rng.randn(2, b, r, 4 * k).astype(np.float32)
    iw = (rng.rand(b, r, 4 * k) > 0.5).astype(np.float32)
    ow = (rng.rand(b, r, 4 * k) > 0.3).astype(np.float32)
    mlog = (rng.randn(b, 6, m, m, k) * 2).astype(np.float32)
    mtgt = (rng.rand(b, 6, m, m) > 0.4).astype(np.float32)
    mvalid = rng.rand(b, 6) > 0.3
    got = {
        "ce": losses.softmax_cross_entropy(T(logits), T(labels), T(valid)),
        "ce_all": losses.softmax_cross_entropy(T(logits), T(labels)),
        "acc": losses.accuracy(T(logits), T(labels), T(valid)),
        "acc_all": losses.accuracy(T(logits), T(labels)),
        "l1": losses.smooth_l1(T(pred), T(tgt), T(iw), T(ow)),
        "mask": losses.mask_loss(T(mlog), T(mtgt), T(labels[:, :6]), T(mvalid)),
    }
    for i in range(b):  # batched inputs give each image's own loss
        exp = {
            "ce": jlosses.softmax_cross_entropy(logits[i], labels[i], valid[i]),
            "ce_all": jlosses.softmax_cross_entropy(logits[i], labels[i]),
            "acc": jlosses.accuracy(logits[i], labels[i], valid[i]),
            "acc_all": jlosses.accuracy(logits[i], labels[i]),
            "l1": jlosses.smooth_l1(pred[i], tgt[i], iw[i], ow[i]),
            "mask": jlosses.mask_loss(mlog[i], mtgt[i], labels[i, :6], mvalid[i]),
        }
        for name in exp:
            _close(got[name][i], exp[name])
    x = (rng.randn(64) * 20).astype(np.float32)
    t = (rng.rand(64) > 0.5).astype(np.float32)
    _close(losses.sigmoid_cross_entropy_with_logits(T(x), T(t)),
           jlosses.sigmoid_cross_entropy_with_logits(x, t))
    with pytest.raises(NotImplementedError):
        losses.keypoint_loss(None, None, None)


def test_expand_bbox_targets_matches_jax(rng):
    compact = np.concatenate([rng.randint(-1, 81, (20, 1)), rng.randn(20, 4)], 1) \
        .astype(np.float32)
    for got, exp in zip(expand_bbox_targets_device(T(compact), 81), jax_expand(compact, 81)):
        assert torch.equal(got, T(np.array(exp)))


def test_lr_schedule_matches_jax():
    cfg, pcfg = both_configs(lambda c: c.SolverConfig())
    for it in (0, 1, 250, 499, 500, 501, 239999, 240000, 240001, 319999, 320000, 359999):
        _close(solver.get_lr_at_iter(it, pcfg), jsolver.get_lr_at_iter(it, cfg))


def test_frozen_mask_matches_jax():
    params = init_params(PRESETS["e2e_mask_rcnn_R-50-FPN_2x"], seed=0)
    got = solver.frozen_mask(params)
    assert got == jsolver.frozen_mask(params)
    assert not got["conv1_w"] and not got["res2_0_branch2a_w"]
    assert not got["res3_0_branch2a_bn_s"] and got["res3_0_branch2a_w"] and got["fc6_w"]


def test_optimizer_matches_optax(rng):
    """Three updates; the gradient of step 1 is large enough for the clip
    to act. A trainable leaf the loss never reached (no .grad) still
    decays, as optax decays it; frozen leaves stay put."""
    shapes = {"conv1_w": (8, 3, 3, 3), "res2_0_branch2a_w": (8, 8), "res3_0_branch2a_bn_s": (8,),
              "res3_0_branch2a_w": (16, 8), "fc6_w": (32, 16), "fc6_b": (32,),
              "rpn_conv_fpn2_w": (8, 8)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    cfg, pcfg = both_configs(lambda c: c.SolverConfig(base_lr=0.05, warmup_iters=2))
    mask = solver.frozen_mask(p0)
    tx = jsolver.make_optimizer(cfg, jsolver.frozen_mask(p0))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    leaves = {k: T(v.copy()).requires_grad_(mask[k]) for k, v in p0.items()}
    opt = solver.make_optimizer(pcfg, leaves, mask)
    clipped = 0
    for step, gscale in enumerate((1.0, 40.0, 1.0)):
        grads = {k: (rng.randn(*s) * gscale).astype(np.float32) for k, s in shapes.items()}
        grads["rpn_conv_fpn2_w"][:] = 0.0  # unreached: JAX sees zeros, torch no grad
        norm = np.sqrt(sum((grads[k].astype(np.float64) ** 2).sum() for k in mask if mask[k]))
        clipped += norm > cfg.clip_grad_norm
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        for k, v in leaves.items():
            if mask[k] and k != "rpn_conv_fpn2_w":
                v.grad = T(grads[k])
        solver.apply_update(opt, step, pcfg)
        for k in shapes:
            np.testing.assert_allclose(leaves[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-8, err_msg=f"{k} step {step}")
    assert clipped == 1
    assert np.array_equal(leaves["conv1_w"].detach().numpy(), p0["conv1_w"])
    assert not np.array_equal(leaves["rpn_conv_fpn2_w"].detach().numpy(), p0["rpn_conv_fpn2_w"])


def _tiny_batch(rng, k):
    rois = np.array([[4, 4, 60, 40], [10, 20, 120, 60], [0, 0, 127, 63], [30, 5, 50, 30]],
                    np.float32)[None]
    labels = np.array([[3, 0, 7, 0]], np.int32)
    targets = np.zeros((1, 4, 4 * k), np.float32)
    targets[0, 0, 12:16] = rng.randn(4)
    inside = (targets != 0).astype(np.float32)
    return {"image": T((rng.randn(1, 64, 128, 3) * 30).astype(np.float32)), "rois": T(rois),
            "labels": T(labels), "bbox_targets": T(targets), "bbox_inside_weights": T(inside),
            "bbox_outside_weights": T(inside.copy()), "valid": torch.ones((1, 4), dtype=torch.bool)}


def test_checkpoint_resume_is_exact(rng, tmp_path):
    cfg, pcfg = both_configs(
        lambda c: c.PRESETS["fast_rcnn_R-50-FPN_2x"].replace(compute_dtype="float32"))
    _, psolver = both_configs(lambda c: c.SolverConfig(warmup_iters=0))
    params = params_from_jax(init_params(cfg, seed=0))
    batch = _tiny_batch(rng, pcfg.num_classes)
    init_state, make_step = make_train_step(pcfg, psolver)

    two, opt = init_state(params)
    step = make_step(opt)
    for _ in range(2):
        two, straight = step(two, batch)

    state, opt = init_state(params)
    state, _ = make_step(opt)(state, batch)
    path = store.save_checkpoint(str(tmp_path), state.step, state_dict(state))
    assert path.endswith("ckpt-1") and store.latest_checkpoint(str(tmp_path)) == path
    fresh, opt = init_state(params)
    fresh = load_state_dict(fresh, store.restore_checkpoint(path))
    assert fresh.step == 1
    fresh, resumed = make_step(opt)(fresh, batch)
    assert fresh.step == 2
    assert float(resumed["loss"]) == float(straight["loss"])
    for k, v in two.params.items():
        assert torch.equal(fresh.params[k], v), k


@pytest.mark.parametrize("flags", [["--fpn", "--keypoints"],
                                   ["--fpn", "--base-cnn", "missing-R-50.pkl"], [], ["--e2e"]],
                         ids=["--keypoints", "--base-cnn", "no-fpn", "--e2e-no-fpn"])
def test_cli_refuses_unported_modes(flags):
    # --base-cnn is ported; a base CNN file that does not exist is refused.
    # Without --fpn, the C4 presets: refused with --masks and with --e2e
    with pytest.raises(SystemExit):
        train_fast.parse_args(["--ann", "a.json", "--imdir", "im", "--masks", *flags])


def test_cli_trains_and_resumes(tmp_path):
    """``python -m detectorch_tpu_torch.tools.train_fast --fpn --masks`` on
    the synthetic COCO set with proposals: 2 iterations on the CPU write
    ckpt-2, and --resume continues from it to iteration 3."""
    from detectorch_tpu.data.synth import build_synth_coco, write_proposals_pkl

    ann, imdir = build_synth_coco(str(tmp_path / "ds"), n_images=2, height=96, width=128,
                                  seed=7)
    props = write_proposals_pkl(ann, str(tmp_path / "props.pkl"))
    out = str(tmp_path / "run")
    args = [sys.executable, "-m", "detectorch_tpu_torch.tools.train_fast", "--ann", ann,
            "--imdir", imdir, "--proposals", props, "--fpn", "--masks", "--out", out,
            "--checkpoint-period", "2", "--log-period", "1", "--base-lr", "0.001",
            "--target-size", "96", "--max-size", "128", "--blob", "96", "128",
            "--rois-per-image", "16", "--device", "cpu"]
    first = subprocess.run(args + ["--max-iter", "2"], capture_output=True, text=True,
                           timeout=300, cwd=REPO)
    assert first.returncode == 0, first.stderr[-2000:]
    assert first.stdout.count("json_stats") == 2 and "loss_mask" in first.stdout
    assert os.path.exists(os.path.join(out, "ckpt-2"))
    second = subprocess.run(args + ["--max-iter", "3", "--resume"], capture_output=True,
                            text=True, timeout=300, cwd=REPO)
    assert second.returncode == 0, second.stderr[-2000:]
    assert f"resumed from {os.path.join(out, 'ckpt-2')} at iter 2" in second.stdout
    assert second.stdout.count("json_stats") == 1 and '"iter": 2' in second.stdout
    assert os.path.exists(os.path.join(out, "ckpt-3"))


def test_cli_trains_from_a_base_cnn(tmp_path):
    """--base-cnn: an ImageNet base CNN pkl written by the JAX package's
    caffe2 exporter (backbone blobs only) is loaded before 2 iterations of
    Fast R-CNN training on the CPU."""
    import pickle

    from detectorch_tpu.checkpoint import caffe2_import as jc2
    from detectorch_tpu.data.synth import build_synth_coco, write_proposals_pkl
    from detectorch_tpu.models.resnet import init_resnet_params

    ann, imdir = build_synth_coco(str(tmp_path / "ds"), n_images=2, height=96, width=128,
                                  seed=8)
    props = write_proposals_pkl(ann, str(tmp_path / "props.pkl"))
    backbone = init_resnet_params("resnet50", include_c5=True, seed=11)
    base = str(tmp_path / "R-50.pkl")
    with open(base, "wb") as f:
        pickle.dump({"blobs": jc2.export_to_caffe2_layout(
            backbone, PRESETS["fast_rcnn_R-50-FPN_2x"])}, f, protocol=2)
    out = str(tmp_path / "run")
    proc = subprocess.run(
        [sys.executable, "-m", "detectorch_tpu_torch.tools.train_fast", "--ann", ann,
         "--imdir", imdir, "--proposals", props, "--fpn", "--base-cnn", base, "--out", out,
         "--max-iter", "2", "--checkpoint-period", "2", "--log-period", "1",
         "--base-lr", "0.001", "--target-size", "96", "--max-size", "128",
         "--blob", "96", "128", "--rois-per-image", "16", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        # the Tier-1 command's six workers share the cores: one torch thread
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "loaded base CNN weights" in proc.stdout and proc.stdout.count("json_stats") == 2
    saved = store.restore_checkpoint(os.path.join(out, "ckpt-2"))["params"]
    # conv1 and res2 are frozen: they hold the base CNN's values, in the
    # port's layout (conv1 flipped back from caffe2's BGR to RGB)
    exp = params_from_jax({k: backbone[k] for k in ("conv1_w", "res2_0_branch2a_w")})
    for k, v in exp.items():
        assert torch.equal(saved[k], v), k


def _train_cli(tmp_path, name, ann, imdir, *flags):
    """Two iterations of the port's trainer on the CPU with one torch thread;
    returns its stdout and the params of ckpt-2."""
    out = str(tmp_path / name)
    proc = subprocess.run(
        [sys.executable, "-m", "detectorch_tpu_torch.tools.train_fast", "--ann", ann,
         "--imdir", imdir, "--fpn", "--out", out, "--max-iter", "2", "--checkpoint-period",
         "2", "--log-period", "1", "--base-lr", "0.001", "--target-size", "96", "--max-size",
         "128", "--blob", "96", "128", "--rois-per-image", "16", "--device", "cpu", *flags],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("json_stats") == 2
    return proc.stdout, store.restore_checkpoint(os.path.join(out, "ckpt-2"))["params"]


def test_cli_e2e_prefetch_is_exact(tmp_path):
    """``train_fast --fpn --e2e --masks`` on the synthetic COCO set, no
    proposal file: 2 iterations move the RPN head and the mask head; with
    ``--prefetch 2`` (batches from a producer thread) the params after 2
    iterations are equal bit for bit."""
    from detectorch_tpu.data.synth import build_synth_coco

    ann, imdir = build_synth_coco(str(tmp_path / "ds"), n_images=3, height=96, width=128,
                                  seed=9)
    out, params = _train_cli(tmp_path, "sync", ann, imdir, "--e2e", "--masks")
    assert all(k in out for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_mask"))
    _, prefetched = _train_cli(tmp_path, "prefetch", ann, imdir, "--e2e", "--masks",
                               "--prefetch", "2")
    assert params.keys() == prefetched.keys()
    for k, v in params.items():
        assert torch.equal(prefetched[k], v), k
    init = params_from_jax(init_params(PRESETS["e2e_mask_rcnn_R-50-FPN_2x"], seed=3))
    for k in ("conv_rpn_fpn2_w", "rpn_cls_logits_fpn2_w", "conv5_mask_w", "fc6_w"):
        assert not torch.equal(params[k], init[k]), k


@pytest.mark.parametrize("mode", ["e2e", "fast"])
def test_cli_device_preprocess_trains(tmp_path, mode):
    """``--device-preprocess``: uint8 images resized on the device, in the
    e2e step and in the Fast R-CNN step from proposals (compact targets)."""
    from detectorch_tpu.data.synth import build_synth_coco, write_proposals_pkl

    ann, imdir = build_synth_coco(str(tmp_path / "ds"), n_images=2, height=90, width=120,
                                  seed=10)
    flags = ["--e2e"] if mode == "e2e" else [
        "--proposals", write_proposals_pkl(ann, str(tmp_path / "props.pkl"))]
    out, params = _train_cli(tmp_path, "run", ann, imdir, "--device-preprocess", *flags)
    assert ("loss_rpn_cls" in out) == (mode == "e2e")
    assert all(bool(torch.isfinite(v).all()) for v in params.values())

"""The port's headline benchmark: batched inference img/s, or the Fast R-CNN
training step's (``BENCH_MODE=train``).

The counterpart of the JAX repository's ``bench.py``, with its knobs (env
vars) and its one JSON line:

  python -m detectorch_tpu_torch.tools.bench                  # on the card
  torchrun --nproc_per_node N -m detectorch_tpu_torch.tools.bench
  BENCH_DEVICE=cpu python -m detectorch_tpu_torch.tools.bench

Default mode: ``parallel.mesh.make_batched_inference_fn`` over ``make_mesh()``
(world 1, or torchrun's ranks), random ``init_params(seed 0)`` weights, a
batch of BENCH_PER_DEV_BATCH (16) images per rank at 832x1344 built as JAX
builds it (``RandomState(0)``, ``randn * 50``, scale 1.66, 500x800
originals). One request builds the kernels, one warms, then BENCH_ITERS (10)
timed requests, each ended by fetching the scores.

Knobs: BENCH_PRESET (e2e_mask_rcnn_R-50-FPN_2x; RPN presets only),
BENCH_COMPUTE_DTYPE, BENCH_ROI_ALIGN_PRECISION, BENCH_NMS_PREFILTER as in
JAX; BENCH_ROI_ALIGN_FWD defaults to 'exact' (the TPU tiers 'bf16x3' and
'bf16' raise ``ValueError``); BENCH_S2D_STEM raises ``NotImplementedError``
(a TPU layout). BENCH_MODE=train: ``train/train_step.make_train_step`` for
fast_rcnn_R-50-FPN_2x, batch BENCH_PER_DEV_BATCH (8), 512 random rois per
image, as JAX's bench_train builds it. The port adds BENCH_DEVICE ('cuda';
'cpu' runs on the CPU).

The line holds JAX's keys (metric, value, unit, vs_baseline, tier) plus
device, peak_memory_gib, the per-iteration ms and the RoIAlign launches.
vs_baseline is null: JAX's baselines (BASELINE.json's v5e-8 target and
BASELINE_TRAIN.json's round-2 step) are TPU numbers, no target for the port.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
from detectorch_tpu_torch.config import PRESETS, SolverConfig, TestConfig
from detectorch_tpu_torch.models.detector import init_params
from detectorch_tpu_torch.tools import measure

FLAGSHIP = "e2e_mask_rcnn_R-50-FPN_2x"
HEIGHT, WIDTH = 832, 1344  # the production bucket
TRAIN_PRESET = "fast_rcnn_R-50-FPN_2x"
TRAIN_ROIS = 512
TRAIN_IMPL = "gather"  # JAX's choice off the TPU; every exact name runs the port's kernels
NO_BASELINE = ("vs_baseline null: JAX's baselines (BASELINE.json, BASELINE_TRAIN.json) "
               "are TPU numbers, not targets for the port")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def inference_config(env: Mapping):
    """(preset, ModelConfig, TestConfig) from the BENCH_* knobs."""
    preset = env.get("BENCH_PRESET", FLAGSHIP)
    cfg = PRESETS[preset]
    if not cfg.use_rpn:
        raise SystemExit("bench covers RPN-driven presets only")
    if env.get("BENCH_ROI_ALIGN_PRECISION"):
        cfg = cfg.replace(roi_align_precision=env["BENCH_ROI_ALIGN_PRECISION"])
    if env.get("BENCH_COMPUTE_DTYPE"):
        cfg = cfg.replace(compute_dtype=env["BENCH_COMPUTE_DTYPE"])
    if env.get("BENCH_S2D_STEM"):
        cfg = cfg.replace(s2d_stem=True)
    cfg = cfg.replace(roi_align_fwd_precision=env.get("BENCH_ROI_ALIGN_FWD") or "exact")
    test_cfg = TestConfig(nms_topk_prefilter=int(env.get("BENCH_NMS_PREFILTER", "0")))
    return preset, cfg, test_cfg


def inference_inputs(batch: int, height: int, width: int):
    """JAX's bench batch: (images, scales, orig_h, orig_w) numpy."""
    rng = np.random.RandomState(0)
    images = (rng.randn(batch, height, width, 3) * 50).astype(np.float32)
    return (images, np.full(batch, 1.66, np.float32), np.full(batch, 500.0, np.float32),
            np.full(batch, 800.0, np.float32))


def inference_setup(cfg, test_cfg, device: torch.device, per_rank_batch: int, height: int,
                    width: int):
    """(fn, params, batch rows, mesh, global batch) of the default mode: the
    mesh over the process group (or 1x1), this rank's params and rows."""
    from detectorch_tpu_torch.parallel.mesh import (
        init_distributed_from_env,
        make_batched_inference_fn,
        make_mesh,
        shard_batch,
        shard_params,
    )

    init_distributed_from_env(backend="gloo" if device.type == "cpu" else None)
    # on the card the mesh takes its default device (this rank's card)
    mesh = make_mesh(model_parallel=1, device=device if device.type == "cpu" else None)
    fn = make_batched_inference_fn(cfg, test_cfg, mesh)
    params = params_to_device(shard_params(params_from_jax(init_params(cfg, seed=0)), mesh),
                              mesh.device)
    b = mesh.size("data") * per_rank_batch
    rows = shard_batch(mesh, *inference_inputs(b, height, width))
    return fn, params, rows, mesh, b


def bench_inference(env: Mapping, device: torch.device) -> Dict:
    preset, cfg, test_cfg = inference_config(env)
    h, w = HEIGHT, WIDTH
    fn, params, rows, mesh, b = inference_setup(
        cfg, test_cfg, device, int(env.get("BENCH_PER_DEV_BATCH", "16")), h, w)
    iters = int(env.get("BENCH_ITERS", "10"))
    dev = mesh.device

    def run_once():
        out = fn(params, *rows)
        out.detections.scores.cpu()  # the fetch ends the request, as JAX's
        return out

    log(f"bench: {preset} batch={b} {h}x{w} on {mesh}")
    _, first = measure.host_ms(run_once, dev)
    log(f"bench: first request (kernel build included): {first / 1e3:.1f} s")
    run_once()
    measure.reset_peak_memory(dev)
    start = measure.launches()
    ms = [measure.host_ms(run_once, dev)[1] for _ in range(iters)]
    counts = measure.launches_since(start)
    rate = b * len(ms) * 1e3 / sum(ms)
    log(f"bench: steady {sum(ms) / len(ms):.1f} ms/batch -> {rate:.2f} img/s")
    line = {
        "metric": ("mask_rcnn_r50_fpn_inference_throughput" if preset == FLAGSHIP
                   else f"{preset}_inference_throughput"),
        "value": rate,
        "unit": (f"images/sec ({mesh.size(None)} rank(s), batch {b}, {h}x{w}, "
                 f"compute={cfg.compute_dtype}, roi_align={cfg.roi_align_precision}; "
                 f"{NO_BASELINE})"),
        "vs_baseline": None,
        "tier": {"compute_dtype": cfg.compute_dtype,
                 "roi_align_precision": cfg.roi_align_precision,
                 "roi_align_fwd_precision": cfg.roi_align_fwd_precision},
        "device": measure.device_info(dev),
        "peak_memory_gib": measure.peak_memory_gib(dev),
        "ms": ms,
        "launches": counts,
        "requests": iters,
        "batch": b,
    }
    return measure.emit(line) if mesh.rank == 0 else line


def train_inputs(num_classes: int, batch: int, rois_per_image: int, height: int, width: int):
    """JAX's bench_train batch (numpy, host-blob schema): random rois in
    each image's quadrants, ``randn * 40`` images, random labels, zero
    targets, every roi valid."""
    b, r, h, w, k = batch, rois_per_image, height, width, num_classes
    rng = np.random.RandomState(0)
    rois = np.stack([np.stack([
        rng.uniform(0, w / 2, r), rng.uniform(0, h / 2, r),
        rng.uniform(w / 2, w - 1, r), rng.uniform(h / 2, h - 1, r)], 1)
        for _ in range(b)]).astype(np.float32)
    return {
        "image": (rng.randn(b, h, w, 3) * 40).astype(np.float32),
        "rois": rois,
        "labels": rng.randint(0, k, (b, r)).astype(np.int32),
        "bbox_targets": np.zeros((b, r, 4 * k), np.float32),
        "bbox_inside_weights": np.zeros((b, r, 4 * k), np.float32),
        "bbox_outside_weights": np.zeros((b, r, 4 * k), np.float32),
        "valid": np.ones((b, r), bool),
    }


def train_config(env: Mapping):
    cfg = PRESETS[TRAIN_PRESET]
    if env.get("BENCH_ROI_ALIGN_FWD"):
        cfg = cfg.replace(roi_align_fwd_precision=env["BENCH_ROI_ALIGN_FWD"])
    return cfg


def train_setup(cfg, device: torch.device, batch: int, height: int, width: int,
                rois_per_image: int = TRAIN_ROIS, params: Optional[Dict] = None):
    """(state, step, batch) of the train mode: init_params(seed 0) (unless
    `params`, port-layout tensors, are given), JAX's batch on `device`, and
    ``make_train_step(cfg, SolverConfig(), roi_align_impl=TRAIN_IMPL)``."""
    from detectorch_tpu_torch.train.train_step import make_train_step

    if params is None:
        params = params_from_jax(init_params(cfg, seed=0))
    params = params_to_device(params, device)
    blobs = {k: torch.from_numpy(v).to(device) for k, v in
             train_inputs(cfg.num_classes, batch, rois_per_image, height, width).items()}
    init_state, make_step = make_train_step(cfg, SolverConfig(), roi_align_impl=TRAIN_IMPL)
    state, opt = init_state(params)
    return state, make_step(opt), blobs


def bench_train(env: Mapping, device: torch.device) -> Dict:
    cfg = train_config(env)
    b, r = int(env.get("BENCH_PER_DEV_BATCH", "8")), TRAIN_ROIS
    h, w = HEIGHT, WIDTH
    state, step, blobs = train_setup(cfg, device, b, h, w, r)
    iters = int(env.get("BENCH_ITERS", "10"))

    def run_once():
        nonlocal state
        state, metrics = step(state, blobs)
        return metrics

    log(f"bench: train step {TRAIN_PRESET} batch={b} {h}x{w} {r} rois/img, "
        f"impl={TRAIN_IMPL} on {device}")
    metrics, first = measure.host_ms(run_once, device)
    log(f"bench: first step (kernel build included): {first / 1e3:.1f} s")
    measure.reset_peak_memory(device)
    start = measure.launches()
    ms = []
    for _ in range(iters):
        metrics, t = measure.host_ms(run_once, device)
        ms.append(t)
    counts = measure.launches_since(start)
    loss = float(metrics["loss"])
    rate = b * len(ms) * 1e3 / sum(ms)
    log(f"bench: steady {sum(ms) / len(ms):.1f} ms/step -> {rate:.2f} img/s, loss {loss:.4f}")
    return measure.emit({
        "metric": "fast_rcnn_r50_fpn_train_step_throughput",
        "value": rate,
        "unit": (f"images/sec (1 device, batch {b}, {h}x{w}, {r} rois/img, "
                 f"roi_align={TRAIN_IMPL}, the port's exact forward and backward kernels; "
                 f"{NO_BASELINE})"),
        "tier": {"roi_align_fwd_precision": cfg.roi_align_fwd_precision,
                 "bwd_precision": "exact"},
        "vs_baseline": None,
        "device": measure.device_info(device),
        "peak_memory_gib": measure.peak_memory_gib(device),
        "ms": ms,
        "launches": counts,
        "steps": iters,
        "loss": loss,
    })


def main(env: Optional[Mapping] = None) -> Dict:
    """Run the benchmark the BENCH_* knobs of `env` (default os.environ)
    describe; returns its line."""
    env = os.environ if env is None else env
    device = measure.resolve_device(env.get("BENCH_DEVICE", "cuda"), "bench",
                                    "BENCH_DEVICE=cpu")
    if env.get("BENCH_MODE") == "train":
        return bench_train(env, device)
    return bench_inference(env, device)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch port (detectorch_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases — each passes or the script exits non-zero:

  1. the device: nvidia-smi's name and power limit, torch's device name;
  2. the build of the RoIAlign kernel from csrc/, with its time;
  3. the kernel against its plain PyTorch version on the card, at the main
     path's shapes (batch 8 pyramids at 832x1344, C = 256; 1000 rois per
     image at 7x7 and 108 at 14x14), bf16 and fp32 features, with CUDA-event
     times of both;
  4. the main path: e2e_mask_rcnn_R-50-FPN_2x, bf16, batch 8 at 832x1344,
     random weights from init_params(seed 0); one warm-up request, then three
     timed requests, with the kernel's launch count checked;
  5. one image through the whole path in fp32 (TF32 off), with the kernel
     and with the plain RoIAlign: equal rois, cls_scores and masks within
     tolerance.

The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PRESET = "e2e_mask_rcnn_R-50-FPN_2x"
BATCH, HEIGHT, WIDTH = 8, 832, 1344
BOX_ROIS, MASK_ROIS = 1000, 108  # box call; mask call = 100 detections + 8 tie slots
# kernel vs plain: both compute in fp32 from the same (bf16-exact or fp32)
# feature values and the same roi geometry; only the order of the fp32 sums
# over <= 16 weighted taps per bin differs, on outputs |v| < ~5: ~1e-6
KERNEL_ATOL = 1e-5
# fp32 main path, kernel vs plain RoIAlign: roi features differ by fp32
# summation order (~1e-6); through fc6/fc7 that moves softmax probabilities
# (~1/81) and deltas by far less than these bounds
CLS_ATOL, DELTA_ATOL, MASK_ATOL = 1e-5, 1e-4, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def make_pyramid(gen, batch, height, width, channels, dtype, device):
    """NHWC P2..P5 (strides 4..32) of standard-normal features."""
    import torch

    return [
        torch.randn((batch, height // s, width // s, channels), generator=gen,
                    device=device).to(dtype)
        for s in (4, 8, 16, 32)
    ]


def make_rois(gen, batch, n, height, width, device):
    """(B, N, 4) image-space rois: random boxes plus edge cases — partly
    outside the image, degenerate (x2 < x1), extreme aspect ratios that
    overflow the TPU kernel's 64-slab, tiny and whole-image boxes."""
    import torch

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)

    x1 = u(batch, n) * width * 1.1 - 0.05 * width
    y1 = u(batch, n) * height * 1.1 - 0.05 * height
    bw = torch.exp(u(batch, n) * 6.0) * 4.0  # 4 .. 1600 px
    bh = bw * torch.exp((u(batch, n) - 0.5) * 3.0)
    rois = torch.stack([x1, y1, x1 + bw, y1 + bh], dim=-1)
    edge = torch.tensor([
        [-40.0, -30.0, 120.0, 90.0],              # partly outside, top-left
        [width - 60.0, height - 50.0, width + 80.0, height + 70.0],
        [300.0, 200.0, 250.0, 150.0],             # degenerate: x2 < x1
        [0.0, 400.0, width - 1.0, 410.0],         # 1344 x 10: extreme aspect
        [600.0, 0.0, 608.0, height - 1.0],        # 9 x 832
        [0.0, 0.0, width - 1.0, height - 1.0],    # whole image
        [100.0, 100.0, 100.5, 100.5],             # tiny
        [-500.0, -500.0, -400.0, -450.0],         # fully outside
    ], device=device)
    rois[:, : edge.shape[0]] = edge
    return rois


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[1 device] {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return name, smi


def phase_build():
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_fwd

    t0 = time.perf_counter()
    path = roi_align_fwd.build()
    log(f"[2 build] {os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.2f} s")
    for line in roi_align_fwd.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"          ptxas: {line.strip()}")


def phase_kernel(device, batch=BATCH, height=HEIGHT, width=WIDTH, channels=256,
                 timing=True):
    """Kernel vs plain at the main path's shapes; returns the summary."""
    import torch

    from detectorch_tpu.config import PRESETS
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_fwd
    from detectorch_tpu_torch.ops.fpn_levels import map_rois_to_fpn_levels
    from detectorch_tpu_torch.ops.roi_align import multilevel_roi_align

    scales = PRESETS[PRESET].fpn_spatial_scales
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    summary = {"max_abs_err": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        feats = make_pyramid(gen, batch, height, width, channels, dtype, device)
        for pooled, n in ((7, BOX_ROIS), (14, MASK_ROIS)):
            rois = make_rois(gen, batch, n, height, width, device).reshape(-1, 4).contiguous()
            levels = (map_rois_to_fpn_levels(rois) - 2).contiguous()
            bidx = torch.arange(batch, dtype=torch.int32, device=device).repeat_interleave(n)
            args = (feats, rois, bidx, levels, scales, pooled, pooled, 2)
            got = roi_align_fwd(*args)
            ref = multilevel_roi_align(*args)
            if device.type == "cuda":
                torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            summary["max_abs_err"] = max(summary["max_abs_err"], err)
            msg = (f"[3 kernel] {str(dtype)[6:]:8s} {pooled}x{pooled} x {batch}x{n} rois: "
                   f"max|kernel - plain| = {err:.3g} (tol {KERNEL_ATOL:g})")
            if timing:
                ms = cuda_time_ms(lambda: roi_align_fwd(*args), iters=20)
                plain_ms = cuda_time_ms(lambda: multilevel_roi_align(*args), iters=3, warmup=1)
                r = batch * n
                msg += (f"; kernel {ms:.4f} ms ({ms * 1e3 / r:.4f} us/roi), "
                        f"plain {plain_ms:.4f} ms ({plain_ms * 1e3 / r:.4f} us/roi)")
                if dtype == torch.bfloat16 and pooled == 7:
                    summary["ms"], summary["plain_ms"] = ms, plain_ms
            log(msg)
            check(err <= KERNEL_ATOL, f"kernel disagrees with plain version: {err}")
            check(bool(torch.isfinite(got).all()), "kernel output not finite")
            del got, ref
    return summary


def _device_params(params, device):
    import torch

    out = {}
    for k, v in params.items():
        v = v.to(device)
        out[k] = v.contiguous(memory_format=torch.channels_last) if v.dim() == 4 else v
    return out


def _batch(gen, batch, height, width, device):
    import torch

    images = torch.randn((batch, height, width, 3), generator=gen, device=device) * 50.0
    scales = torch.full((batch,), 1.66, device=device)
    orig_h = torch.full((batch,), 500.0, device=device)
    orig_w = torch.full((batch,), 800.0, device=device)
    return images, scales, orig_h, orig_w


def check_outputs(out, cfg, test_cfg, batch):
    """Shapes, finiteness and validity bookkeeping of ModelOutputs."""
    import torch

    k = test_cfg.detections_per_img + test_cfg.detections_tie_slack
    n = cfg.rpn.post_nms_top_n
    m = cfg.mask.resolution
    d = out.detections
    shapes = {
        "rois": (out.rois, (batch, n, 4)),
        "roi_valid": (out.roi_valid, (batch, n)),
        "cls_scores": (out.cls_scores, (batch, n, cfg.num_classes)),
        "bbox_deltas": (out.bbox_deltas, (batch, n, 4 * cfg.num_classes)),
        "det_boxes": (d.boxes, (batch, k, 4)),
        "det_scores": (d.scores, (batch, k)),
        "det_classes": (d.classes, (batch, k)),
        "det_valid": (d.valid, (batch, k)),
        "masks": (out.masks, (batch, k, m, m)),
    }
    for name, (t, shape) in shapes.items():
        check(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"{name} not finite")
    check(bool(((out.masks >= 0) & (out.masks <= 1)).all()), "mask probabilities outside [0, 1]")
    n_valid = d.valid.sum(dim=1)
    check(bool((d.scores[d.valid] > test_cfg.score_thresh).all()), "valid detection below threshold")
    check(bool((d.scores[~d.valid] == 0).all()) and bool((d.classes[~d.valid] == 0).all()),
          "invalid detection slots not zeroed")
    check(bool(((d.classes[d.valid] >= 1) & (d.classes[d.valid] < cfg.num_classes)).all()),
          "detection class out of range")
    check(bool((n_valid <= k).all()), "more valid detections than slots")
    check(bool((out.roi_valid.sum(dim=1) > 0).all()), "an image has no valid roi")
    return n_valid.tolist(), out.roi_valid.sum(dim=1).tolist()


def phase_main_path(device, batch=BATCH, height=HEIGHT, width=WIDTH, cfg=None,
                    test_cfg=None, requests=3, card=""):
    import torch

    from detectorch_tpu.config import PRESETS, TestConfig
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax
    from detectorch_tpu_torch.models.detector import init_params, make_inference_fn
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_fwd

    cfg = cfg or PRESETS[PRESET]
    test_cfg = test_cfg or TestConfig()
    t0 = time.perf_counter()
    params = _device_params(params_from_jax(init_params(cfg, seed=0)), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    batch_args = _batch(gen, batch, height, width, device)
    log(f"[4 main] {cfg.name} compute={cfg.compute_dtype} batch={batch} {height}x{width}: "
        f"params + inputs in {time.perf_counter() - t0:.2f} s")
    fwd = make_inference_fn(cfg, test_cfg)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    fwd(params, *batch_args)
    sync()
    log(f"[4 main] warm-up request: {time.perf_counter() - t0:.3f} s")
    roi_align_fwd.launches = 0
    times = []
    for _ in range(requests):
        t0 = time.perf_counter()
        out = fwd(params, *batch_args)
        sync()
        times.append(time.perf_counter() - t0)
    launches = roi_align_fwd.launches
    n_valid, n_rois = check_outputs(out, cfg, test_cfg, batch)
    total = sum(times)
    log(f"[4 main] requests: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms -> "
        f"{batch * requests / total:.2f} img/s on {card or device}; valid rois per image {n_rois}; "
        f"valid detections per image {n_valid}; kernel launches {launches}")
    if device.type == "cuda":
        check(launches == 2 * requests,
              f"RoIAlign kernel launched {launches} times in {requests} requests, expected 2 each")
    return launches, batch * requests / total, params


def phase_fp32_parity(device, params, height=HEIGHT, width=WIDTH, cfg=None, test_cfg=None):
    """One image in fp32: the whole path with the kernel vs the plain RoIAlign."""
    import torch

    from detectorch_tpu.config import PRESETS, TestConfig
    from detectorch_tpu_torch.models import fpn as fpn_mod
    from detectorch_tpu_torch.models import resnet as resnet_mod
    from detectorch_tpu_torch.models.detector import make_inference_fn, mask_branch
    from detectorch_tpu_torch.ops.roi_align import multilevel_roi_align

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (cfg or PRESETS[PRESET]).replace(compute_dtype="float32")
    test_cfg = test_cfg or TestConfig()
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    args = _batch(gen, 1, height, width, device)
    out_k = make_inference_fn(cfg, test_cfg)(params, *args)
    out_p = make_inference_fn(cfg, test_cfg, roi_align=multilevel_roi_align)(params, *args)
    check_outputs(out_k, cfg, test_cfg, 1)
    check(torch.equal(out_k.rois, out_p.rois) and torch.equal(out_k.roi_valid, out_p.roi_valid),
          "rois differ between kernel and plain runs")
    cls_err = (out_k.cls_scores - out_p.cls_scores).abs().max().item()
    delta_err = (out_k.bbox_deltas - out_p.bbox_deltas).abs().max().item()
    # masks of the same detections through both RoIAlign versions (the
    # detection top-K of random weights sits on near-ties)
    with torch.inference_mode():
        feats = resnet_mod.multilevel_body(params, args[0], cfg.arch)
        pyramid = fpn_mod.fpn_neck(params, feats, cfg.arch)
        d = out_k.detections
        masks_p = mask_branch(params, cfg, pyramid, d.boxes, d.classes, args[1],
                              roi_align=multilevel_roi_align)
    mask_err = (out_k.masks - masks_p).abs().max().item()
    same_dets = torch.equal(out_k.detections.classes, out_p.detections.classes) \
        and torch.equal(out_k.detections.valid, out_p.detections.valid)
    log(f"[5 fp32] 1 image, kernel vs plain RoIAlign: rois equal; "
        f"max|d cls_scores| {cls_err:.3g} (tol {CLS_ATOL:g}), "
        f"max|d bbox_deltas| {delta_err:.3g} (tol {DELTA_ATOL:g}), "
        f"max|d masks| {mask_err:.3g} (tol {MASK_ATOL:g}); "
        f"same detections selected: {same_dets}; "
        f"valid detections {int(out_k.detections.valid.sum())}")
    check(cls_err <= CLS_ATOL, f"cls_scores differ by {cls_err}")
    check(delta_err <= DELTA_ATOL, f"bbox_deltas differ by {delta_err}")
    check(mask_err <= MASK_ATOL, f"masks differ by {mask_err}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "detectorch_tpu_torch")):
        print(f"chip_smoke: no detectorch_tpu_torch/ beside {__file__}; run it from "
              "the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    device = torch.device("cuda", 0)
    name, smi = phase_device()
    phase_build()
    summary = phase_kernel(device)
    launches, _, params = phase_main_path(device, card=smi)
    phase_fp32_parity(device, params)
    kernels = [{
        "name": "roi_align_fwd",
        "route": "cuda",
        "source": "detectorch_tpu_torch/csrc/roi_align_fwd.cu",
        "replaces": "detectorch_tpu/ops/pallas/roi_align_kernel.py:164",
        "launches": launches,
        "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"],
        "plain_ms": summary["plain_ms"],
    }]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

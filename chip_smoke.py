#!/usr/bin/env python3
"""Smoke test of the PyTorch port (detectorch_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases — each passes or the script exits non-zero:

  1. the device: nvidia-smi's name and power limit, torch's device name;
  2. the build of both RoIAlign kernels from csrc/ (one nvcc each, started
     together), with its time;
  3. the forward kernel against its plain PyTorch version on the card, at
     the inference and eval paths' shapes (batch 8 pyramids at 832x1344 and
     at 1344x832, C = 256; 1000 rois per image at 7x7 and 108 at 14x14),
     over random rois and over rois half of which crowd around 4 boxes per
     image, bf16 and fp32 features, with CUDA-event times of both at
     832x1344 and each call's bound (the feature bytes its rois touch,
     counted on the card, read once and the output written once) and share
     of it;
  4. the inference path: e2e_mask_rcnn_R-50-FPN_2x, bf16, batch 8 at
     832x1344, random weights from init_params(seed 0); one warm-up request,
     then three timed requests, with the kernel's launch count checked;
  5. one image through the whole inference path in fp32 (TF32 off), with the
     kernel and with the plain RoIAlign: equal rois, cls_scores and masks
     within tolerance;
  6. the backward kernel against its plain version at the training shapes
     (batch 8 pyramids at 832x1344, C = 256; 512 rois per image at 7x7 and
     128 at 14x14), over random rois and over rois half of which crowd
     around 4 boxes per image, as sampled foreground rois do; bf16 and fp32
     gradients: fp32 within 1e-5 * max|plain|, bf16 equal to the fp32
     result rounded once, two launches bitwise equal, CUDA-event times of
     both with each call's bound (g read once, the gradient pyramid written
     once) and share of it; then 3000 rois on one P2 tile, a list past the
     kernel's shared-memory sort, at 7x7 and 14x14: the kernel within
     1e-5 * max|sum| of the float64 sum of the same terms (the plain
     version's distance from it printed beside), two launches bitwise
     equal, bf16 equal to fp32 rounded once;
  7. the training path: e2e_mask_rcnn_R-50-FPN_2x with the mask branch,
     bf16, batch 8 at 832x1344, 512 rois and 128 mask rows per image, from
     synthetic roidb entries; one warm-up step, three timed steps (ms/step,
     img/s, peak memory), 2 forward + 2 backward kernel launches per step,
     finite losses, and the loss lower after 5 steps on the one batch;
  8. one image of the training step in fp32 (TF32 off): gradients through
     the kernels against gradients through the kernel forward with the
     plain backward, and through both plain versions;
  9. COCO evaluation: a synthetic COCO set made with numpy (27 images at
     480x640 and 9 at 640x480, served from memory), init_params(seed 0)
     weights written as a Detectron pkl and read back through the caffe2
     loader, then evaluate_dataset with the batched engine at batch 8,
     on-device preprocessing, bf16, score_thresh 0: img/s end to end with
     its load/submit/finalize split, >= 100 detections per image, every RLE
     of its image's size, 12 + 12 finite COCOeval stats, 2 forward kernel
     launches per batch; then, in fp32 (TF32 off) with masks fetched in
     fp32, the batched engine's results for the first 4 images equal to the
     single-image engine's;
 10. the e2e training path: e2e_mask_rcnn_R-50-FPN_2x with the mask branch,
     bf16, batch 8 in the 832x1344 bucket from the uint8 schema (COCO-sized
     noise images resized on the card), 3-20 gts per image in 128 slots with
     polygon masks, RPN 12000 -> 2000 per level, 512 rois per image: one
     warm-up step, three timed steps (ms/step, img/s, peak memory), 2
     forward + 2 backward kernel launches per step, six finite losses, the
     loss lower after 5 steps on the one batch, the fifth step split by
     stage (a synchronise after each), the most sampled rois on one
     backward tile, and a sixth step under torch.profiler (device busy
     time and idle share, host syncs, the operators with most device time);
 11. one image of the e2e step in fp32 (TF32 off) with one fixed set of
     uniforms: gradients through the kernels against the kernel forward
     with the plain backward and against both plain versions, held as in
     phase 8, and the same sampled rois and labels in all three runs.

The line before the last is a JSON summary of the kernels (their times and
bounds are those of the random bf16 7x7 call; "calls" lists every timed
call; "launches" counts phase 10's three steps, "launches_by_path" each
path's timed run), the line before it nvidia-smi's name and power limit; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
PRESET = "e2e_mask_rcnn_R-50-FPN_2x"
BATCH, HEIGHT, WIDTH = 8, 832, 1344
BOX_ROIS, MASK_ROIS = 1000, 108  # box call; mask call = 100 detections + 8 tie slots
TRAIN_ROIS, TRAIN_MASK_ROWS = 512, 128  # sampled rois per image; fg-capacity mask rows
# kernel vs plain: both compute in fp32 from the same (bf16-exact or fp32)
# feature values and the same roi geometry; only the order of the fp32 sums
# over <= 16 weighted taps per bin differs, on outputs |v| < ~5: ~1e-6
KERNEL_ATOL = 1e-5
# fp32 main path, kernel vs plain RoIAlign: roi features differ by fp32
# summation order (~1e-6); through fc6/fc7 that moves softmax probabilities
# (~1/81) and deltas by far less than these bounds
CLS_ATOL, DELTA_ATOL, MASK_ATOL = 1e-5, 1e-4, 1e-4
# backward kernel vs plain: the same fp32 products of g, bilinear weights and
# 1/count, summed per pixel in another order (the kernel by roi and bin, the
# plain version by index_add_)
BWD_REL = 1e-5
# rois on one tile in phase 6's dense case: more than the backward kernel
# sorts in shared memory (2048)
DENSE_ROIS = 3000
# fp32 training step, one image: gradients through the kernels against the
# plain versions, per trainable leaf, max|d| <= GRAD_REL * max|g|. With the
# kernel forward on both sides every activation is equal, so the backward
# kernel is the only difference; with the plain forward too, a ReLU unit
# whose pre-activation lies within fp32 rounding of zero can switch between
# the two runs and move one channel of a leaf by ~0.5% (seen on the CPU), so
# that comparison is held to cosine >= GRAD_COS and FLIP_REL instead
GRAD_REL, GRAD_COS, FLIP_REL = 1e-4, 0.9999, 1e-2
# eval: (height, width, count) of COCO-sized images; they fall into the
# 832x1344 and 1344x832 buckets, each with a short tail batch
EVAL_IMAGES = ((480, 640, 27), (640, 480, 9))
PARITY_IMAGES = 4
# the least time of a kernel call (NVIDIA's data sheet, H100 SXM at
# 700 W): its bytes over the memory rate, or its fp32
# operations over the CUDA cores' rate, whichever is larger
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


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


def make_clustered_rois(gen, batch, n, height, width, device):
    """make_rois, with the last half of each image's rois jittered around 4
    boxes (by up to 10% of their size), as sampled foreground rois crowd
    around their gt boxes; the boxes are 24 px to 0.6 of the short side."""
    import math

    import torch

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)

    rois = make_rois(gen, batch, n, height, width, device)
    lo, hi = math.log(24.0), math.log(0.6 * min(height, width))
    wh = torch.exp(lo + u(batch, 4, 2) * (hi - lo))
    xy = u(batch, 4, 2) * (torch.tensor([width, height], device=device) - wh)
    boxes = torch.cat([xy, xy + wh], dim=-1)  # (B, 4, 4)
    k = n // 2
    pick = (u(batch, k) * 4).long().clamp_max(3)
    base = torch.gather(boxes, 1, pick[..., None].expand(batch, k, 4))
    size = (base[..., 2:] - base[..., :2]).repeat(1, 1, 2)
    rois[:, n - k:] = base + (u(batch, k, 4) - 0.5) * 0.2 * size
    return rois


def make_dense_rois(gen, n, height, width, device):
    """(n, 4) rois of one image that all cover the P2 tile at its centre:
    40 to 100 px (so they map to P2), centred within 8 px of it."""
    import torch

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)

    centre = torch.tensor([width / 2, height / 2], device=device) + (u(n, 2) - 0.5) * 16.0
    half = (40.0 + u(n, 2) * 60.0) / 2
    return torch.cat([centre - half, centre + half], dim=-1)


def plain_bwd_f64(g, shapes, rois, bidx, levels, scales, pooled_h, pooled_w, sampling_ratio):
    """multilevel_roi_align_backward's sum in float64: the same fp32 taps,
    weights and 1/count, products and sums in float64; a witness of the
    exact sum that both fp32 orders round."""
    import torch

    from detectorch_tpu_torch.ops.roi_align import _bilinear_taps

    idx, wts, inv_count, sizes, s = _bilinear_taps([tuple(f[:3]) for f in shapes], rois, bidx,
                                                   levels, scales, pooled_h, pooled_w, sampling_ratio, 8)
    r, channels = rois.shape[0], shapes[0][-1]
    gs = g.double() * inv_count.double()[:, None, None, None]
    gs = gs[:, :, :, None, None, :].expand(r, pooled_h, pooled_w, s, s, channels) \
        .reshape(r, pooled_h * pooled_w * s * s, channels)
    flat = torch.zeros((sum(sizes), channels), dtype=torch.float64, device=g.device)
    for i, w in zip(idx, wts):
        flat.index_add_(0, i.reshape(-1), (gs * w.double()[..., None]).reshape(-1, channels))
    return [part.reshape(tuple(shape)) for part, shape in zip(flat.split(sizes), shapes)]


def roofline(nbytes: float, flops: float):
    """(bound_ms, bound_by) of a call that moves `nbytes` and does `flops`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roi_align_work(level_shapes, rois, bidx, levels, scales, pooled, channels):
    """What one RoIAlign call over these rois needs: the feature pixels its
    live samples' taps touch (each counted once) and the fp32 operations of
    its taps (an FMA per live tap and channel)."""
    import torch

    from detectorch_tpu_torch.ops.roi_align import _bilinear_taps

    idx, wts, *_ = _bilinear_taps([s[:3] for s in level_shapes], rois, bidx, levels, scales,
                                  pooled, pooled, 2, 8)
    live = wts[0] != 0  # hy * hx > 0 for every live sample
    pixels = torch.unique(torch.cat([i[live] for i in idx])).numel()
    return pixels, 2 * 4 * int(live.sum()) * channels


def fwd_bound(feats, rois, bidx, levels, scales, pooled):
    """The forward's least time: the touched feature bytes read once, rois
    and indices read, the fp32 output written, or its operations."""
    channels = feats[0].shape[-1]
    pixels, flops = roi_align_work([f.shape for f in feats], rois, bidx, levels, scales,
                                   pooled, channels)
    r = rois.shape[0]
    nbytes = (pixels * channels * feats[0].element_size() + 24 * r
              + r * pooled * pooled * channels * 4)
    return roofline(nbytes, flops)


def bwd_bound(shapes, rois, bidx, levels, scales, pooled, out_dtype):
    """The backward's least time: g, rois and indices read once, the whole
    gradient pyramid written once, or its operations."""
    import torch

    channels = shapes[0][-1]
    _, flops = roi_align_work(shapes, rois, bidx, levels, scales, pooled, channels)
    r = rois.shape[0]
    out_bytes = sum(b * h * w * c for b, h, w, c in shapes) \
        * torch.empty((), dtype=out_dtype).element_size()
    return roofline(r * pooled * pooled * channels * 4 + 24 * r + out_bytes, flops)


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
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd, roi_align_fwd

    t0 = time.perf_counter()
    kernels = (roi_align_fwd, roi_align_bwd)
    with ThreadPoolExecutor(len(kernels)) as pool:
        paths = list(pool.map(lambda k: k.build(), kernels))
    log(f"[2 build] {', '.join(os.path.relpath(p, REPO) for p in paths)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for kernel in kernels:
        for line in kernel.build_log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"          ptxas: {line.strip()}")


def phase_kernel(device, batch=BATCH, height=HEIGHT, width=WIDTH, channels=256,
                 timing=True):
    """Kernel vs plain at the main paths' shapes, in both bucket orientations
    (landscape for inference and training, portrait too for eval), over
    random rois and over rois clustered as proposals crowd around objects;
    returns the summary, whose times are the landscape random bf16 7x7
    call's."""
    import torch

    from detectorch_tpu_torch.config import PRESETS
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_fwd
    from detectorch_tpu_torch.ops.fpn_levels import map_rois_to_fpn_levels
    from detectorch_tpu_torch.ops.roi_align import multilevel_roi_align

    scales = PRESETS[PRESET].fpn_spatial_scales
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    # the clustered rois come from a stream of their own, so that the
    # features and the random rois are those of the earlier runs
    gen_clustered = torch.Generator(device=device)
    gen_clustered.manual_seed(8)
    summary = {"max_abs_err": 0.0, "calls": []}
    for h, w in ((height, width), (width, height)):
        timed = timing and (h, w) == (height, width)
        for dtype in (torch.bfloat16, torch.float32):
            feats = make_pyramid(gen, batch, h, w, channels, dtype, device)
            for pooled, n in ((7, BOX_ROIS), (14, MASK_ROIS)):
                for kind, make, g in (("random", make_rois, gen),
                                      ("clustered", make_clustered_rois, gen_clustered)):
                    rois = make(g, batch, n, h, w, device).reshape(-1, 4).contiguous()
                    levels = (map_rois_to_fpn_levels(rois) - 2).contiguous()
                    bidx = torch.arange(batch, dtype=torch.int32,
                                        device=device).repeat_interleave(n)
                    args = (feats, rois, bidx, levels, scales, pooled, pooled, 2)
                    got = roi_align_fwd(*args)
                    ref = multilevel_roi_align(*args)
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                    err = (got - ref).abs().max().item()
                    summary["max_abs_err"] = max(summary["max_abs_err"], err)
                    msg = (f"[3 kernel] {h}x{w} {str(dtype)[6:]:8s} {kind:9s} {pooled}x{pooled} x "
                           f"{batch}x{n} rois: max|kernel - plain| = {err:.3g} "
                           f"(tol {KERNEL_ATOL:g})")
                    if timed:
                        ms = cuda_time_ms(lambda: roi_align_fwd(*args), iters=20)
                        plain_ms = cuda_time_ms(lambda: multilevel_roi_align(*args), iters=3,
                                                warmup=1)
                        bound_ms, bound_by = fwd_bound(feats, rois, bidx, levels, scales, pooled)
                        r = batch * n
                        msg += (f"; kernel {ms:.4f} ms ({ms * 1e3 / r:.4f} us/roi), "
                                f"plain {plain_ms:.4f} ms ({plain_ms * 1e3 / r:.4f} us/roi); "
                                f"bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f}")
                        summary["calls"].append({
                            "call": f"{kind} {str(dtype)[6:]} {pooled}x{pooled} {r} rois",
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by})
                        if kind == "random" and dtype == torch.bfloat16 and pooled == 7:
                            summary.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                           bound_by=bound_by)
                    log(msg)
                    check(err <= KERNEL_ATOL, f"kernel disagrees with plain version: {err}")
                    check(bool(torch.isfinite(got).all()), "kernel output not finite")
                    del got, ref
            del feats
    return summary


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

    from detectorch_tpu_torch.config import PRESETS, TestConfig
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.models.detector import init_params, make_inference_fn
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_fwd

    cfg = cfg or PRESETS[PRESET]
    test_cfg = test_cfg or TestConfig()
    t0 = time.perf_counter()
    params = params_to_device(params_from_jax(init_params(cfg, seed=0)), device)
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

    from detectorch_tpu_torch.config import PRESETS, TestConfig
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


def phase_bwd_kernel(device, batch=BATCH, height=HEIGHT, width=WIDTH, channels=256,
                     timing=True):
    """Backward kernel vs plain backward at the training shapes, over random
    rois and over rois clustered as sampled foreground rois are; returns the
    summary, whose times are the random bf16 7x7 call's."""
    import torch

    from detectorch_tpu_torch.config import PRESETS
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd, roi_tile_lists
    from detectorch_tpu_torch.ops.fpn_levels import map_rois_to_fpn_levels
    from detectorch_tpu_torch.ops.roi_align import multilevel_roi_align_backward

    scales = PRESETS[PRESET].fpn_spatial_scales
    shapes = [(batch, height // s, width // s, channels) for s in (4, 8, 16, 32)]
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    summary = {"max_rel_err": 0.0, "max_abs_err": 0.0, "calls": []}
    for pooled, n in ((7, TRAIN_ROIS), (14, TRAIN_MASK_ROWS)):
        for kind, make in (("random", make_rois), ("clustered", make_clustered_rois)):
            rois = make(gen, batch, n, height, width, device).reshape(-1, 4).contiguous()
            levels = (map_rois_to_fpn_levels(rois) - 2).contiguous()
            bidx = torch.arange(batch, dtype=torch.int32, device=device).repeat_interleave(n)
            g = torch.randn((batch * n, pooled, pooled, channels), generator=gen, device=device)
            args = (g, shapes, rois, bidx, levels, scales, pooled, pooled, 2)
            ref = multilevel_roi_align_backward(*args)
            got = roi_align_bwd(*args)
            again = roi_align_bwd(*args)
            got_bf16 = roi_align_bwd(*args, out_dtype=torch.bfloat16)
            scale = max(r.abs().max().item() for r in ref)
            err = max((a - r).abs().max().item() for a, r in zip(got, ref))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            rounded = all(b.dtype == torch.bfloat16 and torch.equal(b, a.to(torch.bfloat16))
                          for a, b in zip(got, got_bf16))
            summary["max_rel_err"] = max(summary["max_rel_err"], err / scale)
            summary["max_abs_err"] = max(summary["max_abs_err"], err)
            msg = (f"[6 bwd] {kind} {pooled}x{pooled} x {batch}x{n} rois: max|kernel - plain| = "
                   f"{err:.3g} = {err / scale:.3g} of max|plain| {scale:.3g} (tol {BWD_REL:g}); "
                   f"two launches equal: {same}; bf16 = fp32 rounded once: {rounded}")
            if timing:
                for dtype in (torch.bfloat16, torch.float32):
                    ms = cuda_time_ms(lambda: roi_align_bwd(*args, out_dtype=dtype), iters=20)
                    plain_ms = cuda_time_ms(
                        lambda: multilevel_roi_align_backward(*args, out_dtype=dtype),
                        iters=3, warmup=1)
                    bound_ms, bound_by = bwd_bound(shapes, rois, bidx, levels, scales, pooled,
                                                   dtype)
                    r = batch * n
                    msg += (f"; {str(dtype)[6:]} kernel {ms:.4f} ms ({ms * 1e3 / r:.4f} us/roi), "
                            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                            f"share {bound_ms / ms:.3f}")
                    summary["calls"].append({
                        "call": f"{kind} {str(dtype)[6:]} out {pooled}x{pooled} {r} rois",
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by})
                    if kind == "random" and dtype == torch.bfloat16 and pooled == 7:
                        summary.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                       bound_by=bound_by)
            log(msg)
            check(err <= BWD_REL * scale, f"backward kernel disagrees with plain version: {err}")
            check(same, "two launches of the backward kernel differ")
            check(rounded, "bf16 gradient is not the fp32 gradient rounded once")
            check(all(bool(torch.isfinite(a).all()) for a in got),
                  "backward kernel output not finite")
            del ref, got, again, got_bf16
    # a tile list longer than the kernel's shared-memory sort (2048 rois),
    # sorted in device memory: DENSE_ROIS rois of image 0 on one P2 tile,
    # held, as the plain version is, to the float64 sum of the same terms
    for pooled in (7, 14):
        rois = make_dense_rois(gen, DENSE_ROIS, height, width, device)
        levels = (map_rois_to_fpn_levels(rois) - 2).contiguous()
        bidx = torch.zeros(DENSE_ROIS, dtype=torch.int32, device=device)
        g = torch.randn((DENSE_ROIS, pooled, pooled, channels), generator=gen, device=device)
        args = (g, shapes, rois, bidx, levels, scales, pooled, pooled, 2)
        exact = plain_bwd_f64(*args)
        ref = multilevel_roi_align_backward(*args)
        got = roi_align_bwd(*args)
        again = roi_align_bwd(*args)
        got_bf16 = roi_align_bwd(*args, out_dtype=torch.bfloat16)
        scale = max(e.abs().max().item() for e in exact)
        err = max((a - e).abs().max().item() for a, e in zip(got, exact))
        plain_err = max((r - e).abs().max().item() for r, e in zip(ref, exact))
        vs_plain = max((a - r).abs().max().item() for a, r in zip(got, ref))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        rounded = all(torch.equal(b, a.to(torch.bfloat16)) for a, b in zip(got, got_bf16))
        starts, _ = roi_tile_lists(shapes, rois, bidx, levels, scales, pooled, pooled)
        longest = int((starts[1:] - starts[:-1]).max())
        msg = (f"[6 bwd] dense {pooled}x{pooled} x {DENSE_ROIS} rois, {longest} on one tile: "
               f"max|kernel - f64| = {err:.3g} = {err / scale:.3g}, max|plain - f64| = "
               f"{plain_err:.3g} = {plain_err / scale:.3g} of max|f64| {scale:.3g} (tol "
               f"{BWD_REL:g}); max|kernel - plain| = {vs_plain:.3g}; two launches equal: "
               f"{same}; bf16 = fp32 rounded once: {rounded}")
        if timing:
            ms = cuda_time_ms(lambda: roi_align_bwd(*args, out_dtype=torch.bfloat16), iters=20)
            bound_ms, bound_by = bwd_bound(shapes, rois, bidx, levels, scales, pooled,
                                           torch.bfloat16)
            msg += (f"; bf16 kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                    f"share {bound_ms / ms:.3f}")
            summary["calls"].append({
                "call": f"dense bf16 out {pooled}x{pooled} {DENSE_ROIS} rois", "ms": ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "err_vs_f64": err,
                "plain_err_vs_f64": plain_err})
        log(msg)
        check(longest == DENSE_ROIS, f"the longest tile list holds {longest} rois")
        check(err <= BWD_REL * scale, f"backward kernel is {err} from the float64 sum")
        check(same, "two launches of the backward kernel differ on a dense tile")
        check(rounded, "bf16 gradient is not the fp32 gradient rounded once on a dense tile")
        del exact, ref, got, again, got_bf16
    empty = roi_align_bwd(g[:0], shapes, rois[:0], bidx[:0], levels[:0], scales, 14, 14, 2)
    check(all(not e.any() for e in empty), "backward kernel over no rois is not zero")
    return summary


def make_train_batch(rng, batch, height, width, num_classes, rois_per_image, mask_rows,
                     mask_res, device):
    """A training batch built with numpy from synthetic roidb entries: gt
    boxes, jittered and random proposals, the port's bbox regression
    targets and the JAX package's roi sampler (JAX-free once targets are
    set); mask targets are ellipses rasterised in each fg roi's frame."""
    import numpy as np
    import torch

    from detectorch_tpu_torch.config import SamplerConfig
    from detectorch_tpu_torch.data.coco import (
        RoidbEntry,
        _np_bbox_overlaps,
        add_bbox_regression_targets,
    )
    from detectorch_tpu_torch.train.sampler import sample_rois

    keys = ("rois", "labels", "bbox_targets", "bbox_inside_weights", "bbox_outside_weights",
            "valid")
    out = {k: [] for k in keys + ("mask_targets", "mask_valid")}
    yy, xx = (np.mgrid[:mask_res, :mask_res] + 0.5) / mask_res - 0.5
    for _ in range(batch):
        n_gt = rng.randint(3, 9)
        wh = np.exp(rng.uniform(np.log(24), np.log(0.6 * min(height, width)), (n_gt, 2)))
        xy = rng.uniform(0, 1, (n_gt, 2)) * ([width, height] - wh)
        gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        jitter = gt[rng.randint(n_gt, size=40 * n_gt)]
        jitter = jitter + rng.randn(*jitter.shape) * 0.1 * np.tile(jitter[:, 2:] - jitter[:, :2], 2)
        xy = rng.uniform(0, 1, (600, 2)) * [width, height]
        rand = np.concatenate([xy, xy + rng.uniform(8, 400, (600, 2))], 1)
        props = np.clip(np.concatenate([jitter, rand]), 0, [width - 1, height - 1] * 2)
        props[:, 2:] = np.maximum(props[:, 2:], props[:, :2] + 1)
        boxes = np.concatenate([gt, props]).astype(np.float32)
        ov = _np_bbox_overlaps(boxes, gt)
        gt_cls = rng.randint(1, num_classes, n_gt).astype(np.int32)
        arg = ov.argmax(1)
        entry = RoidbEntry(
            image_id=0, file_path="", height=height, width=width, boxes=boxes,
            gt_classes=np.concatenate([gt_cls, np.zeros(len(props), np.int32)]),
            is_crowd=np.zeros(len(boxes), np.uint8), max_overlaps=ov.max(1).astype(np.float32),
            max_classes=np.where(ov.max(1) > 0, gt_cls[arg], 0).astype(np.int32),
            box_to_gt_ind_map=np.where(ov.max(1) > 0, arg, -1).astype(np.int32))
        add_bbox_regression_targets([entry])
        blobs = sample_rois(entry, 1.0, rng, SamplerConfig(rois_per_image=rois_per_image),
                            num_classes)
        for k in keys:
            out[k].append(blobs[k])
        fg = blobs["labels"][:mask_rows] > 0
        c = rng.uniform(-0.15, 0.15, (mask_rows, 2, 1, 1))
        r = rng.uniform(0.2, 0.5, (mask_rows, 2, 1, 1))
        ellipse = ((yy - c[:, 0]) / r[:, 0]) ** 2 + ((xx - c[:, 1]) / r[:, 1]) ** 2 <= 1
        out["mask_targets"].append((ellipse & fg[:, None, None]).astype(np.float32))
        out["mask_valid"].append(fg)
    return {k: torch.from_numpy(np.stack(v)).to(device) for k, v in out.items()}


def phase_train(device, batch=BATCH, height=HEIGHT, width=WIDTH, cfg=None,
                rois_per_image=TRAIN_ROIS, mask_rows=TRAIN_MASK_ROWS, card=""):
    """The training path through both kernels; returns the launch counts
    of the three timed steps and the step rate."""
    import numpy as np
    import torch

    from detectorch_tpu_torch.config import PRESETS, SolverConfig
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.models.detector import init_params
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd, roi_align_fwd
    from detectorch_tpu_torch.train.solver import apply_update
    from detectorch_tpu_torch.train.train_step import box_branch_loss, make_train_step

    cfg = cfg or PRESETS[PRESET]
    t0 = time.perf_counter()
    params = params_to_device(params_from_jax(init_params(cfg, seed=0)), device)
    # random weights on one fixed batch: at the schedule's LR (0.01) the
    # class loss swings over the first steps; 1e-4 makes it fall steadily
    solver = SolverConfig(base_lr=1e-4, warmup_iters=0)
    init_state, make_step = make_train_step(cfg, solver, train_mask=True,
                                            roi_align_impl="pallas-slab")
    state, opt = init_state(params)
    del params
    step = make_step(opt)
    fixed = make_train_batch(np.random.RandomState(0), batch, height, width, cfg.num_classes,
                             rois_per_image, mask_rows, cfg.mask.resolution, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    fixed["image"] = torch.randn((batch, height, width, 3), generator=gen, device=device) * 50.0
    n_fg = int((fixed["labels"] > 0).sum())
    log(f"[7 train] {cfg.name} compute={cfg.compute_dtype} batch={batch} {height}x{width}, "
        f"{rois_per_image} rois ({n_fg} fg in all) and {mask_rows} mask rows per image: "
        f"params + batch in {time.perf_counter() - t0:.2f} s")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def run():
        nonlocal state
        state, metrics = step(state, fixed)
        values = {k: float(v) for k, v in metrics.items()}
        sync()
        check(all(np.isfinite(v) for v in values.values()), f"non-finite metrics {values}")
        return values

    t0 = time.perf_counter()
    losses = [run()["loss"]]
    log(f"[7 train] warm-up step: {time.perf_counter() - t0:.3f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    roi_align_fwd.launches = roi_align_bwd.launches = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(run()["loss"])
        times.append(time.perf_counter() - t0)
    launches = {"roi_align_fwd": roi_align_fwd.launches, "roi_align_bwd": roi_align_bwd.launches}
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else 0.0
    # the fifth step in stages, synchronised after each: forward (loss),
    # backward, optimizer update
    stages = []
    t0 = time.perf_counter()
    total, metrics = box_branch_loss(
        state.params, cfg, fixed["image"], fixed["rois"], fixed["labels"],
        fixed["bbox_targets"], fixed["bbox_inside_weights"], fixed["bbox_outside_weights"],
        fixed["valid"], fixed["mask_targets"], fixed["mask_valid"])
    loss = total.mean()
    sync()
    stages.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    loss.backward()
    sync()
    stages.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    apply_update(opt, state.step, solver)
    sync()
    stages.append(time.perf_counter() - t0)
    last = {k: float(v.detach().mean()) for k, v in metrics.items()}
    last["loss"] = float(loss.detach())
    check(all(np.isfinite(v) for v in last.values()), f"non-finite metrics {last}")
    losses.append(last["loss"])
    rate = batch * len(times) / sum(times)
    log(f"[7 train] steps: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms -> "
        f"{sum(times) / len(times) * 1e3:.1f} ms/step, {rate:.2f} img/s on {card or device}; "
        f"peak memory {peak:.2f} GiB; kernel launches in 3 steps {launches}")
    log(f"[7 train] step 5 in stages: forward {stages[0] * 1e3:.1f} ms, backward "
        f"{stages[1] * 1e3:.1f} ms, optimizer {stages[2] * 1e3:.1f} ms")
    log(f"[7 train] loss over 5 steps on one batch: {', '.join(f'{v:.4f}' for v in losses)}; "
        f"step 5 {', '.join(f'{k} {v:.4f}' for k, v in last.items())}")
    if device.type == "cuda":
        check(launches == {"roi_align_fwd": 6, "roi_align_bwd": 6},
              f"kernel launches {launches} in 3 steps, expected 2 forward + 2 backward each")
    check(losses[-1] < losses[0], f"loss did not fall over 5 steps: {losses}")
    return launches, rate


def compare_grads(got, other):
    """Gradients through the kernels against another run's, per leaf: the
    worst leaf's max|d| / max|g|, the worst leaf's largest error outside its
    worst output channel (a ReLU flip moves one channel), and the lowest
    cosine."""
    worst_rel, worst_rest, worst_cos = 0.0, 0.0, 1.0
    for k, g in got.items():
        scale = other[k].abs().max().item()
        if scale == 0:
            check(g.abs().max().item() == 0, f"{k}: gradient where the plain run has none")
            continue
        per_channel = (g - other[k]).abs().reshape(len(g), -1).amax(dim=1).sort().values
        rest = per_channel[-2].item() if len(per_channel) > 1 else 0.0
        a, e = g.double().flatten(), other[k].double().flatten()
        cos = (a @ e / (a.norm() * e.norm())).item()
        worst_rel = max(worst_rel, per_channel[-1].item() / scale)
        worst_rest = max(worst_rest, rest / scale)
        worst_cos = min(worst_cos, cos)
    return worst_rel, worst_rest, worst_cos


def phase_fp32_grads(device, height=HEIGHT, width=WIDTH, cfg=None, rois_per_image=TRAIN_ROIS,
                     mask_rows=TRAIN_MASK_ROWS):
    """One image of the fp32 training step: gradients through the kernels
    (K), through the kernel forward and the plain backward (KP), and through
    both plain versions (P)."""
    import functools

    import numpy as np
    import torch

    from detectorch_tpu_torch.config import PRESETS, SolverConfig
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.models.detector import init_params
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_fwd
    from detectorch_tpu_torch.ops.roi_align import (
        multilevel_roi_align,
        multilevel_roi_align_backward,
    )
    from detectorch_tpu_torch.ops.roi_align_fused import roi_align_fused
    from detectorch_tpu_torch.train.train_step import box_branch_loss, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (cfg or PRESETS[PRESET]).replace(compute_dtype="float32")
    params = params_to_device(params_from_jax(init_params(cfg, seed=0)), device)
    b = make_train_batch(np.random.RandomState(5), 1, height, width, cfg.num_classes,
                         rois_per_image, mask_rows, cfg.mask.resolution, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    b["image"] = torch.randn((1, height, width, 3), generator=gen, device=device) * 50.0
    init_state, _ = make_train_step(cfg, SolverConfig(), train_mask=True)

    def grads(roi_align):
        state, _ = init_state(params)
        total, _ = box_branch_loss(
            state.params, cfg, b["image"], b["rois"], b["labels"], b["bbox_targets"],
            b["bbox_inside_weights"], b["bbox_outside_weights"], b["valid"],
            b["mask_targets"], b["mask_valid"], roi_align=roi_align)
        total.sum().backward()
        return float(total.detach().sum()), {k: v.grad for k, v in state.params.items()
                                    if v.grad is not None}

    loss_k, g_k = grads(roi_align_fused)
    loss_kp, g_kp = grads(functools.partial(roi_align_fused, fwd=roi_align_fwd,
                                            bwd=multilevel_roi_align_backward))
    loss_p, g_p = grads(functools.partial(roi_align_fused, fwd=multilevel_roi_align,
                                          bwd=multilevel_roi_align_backward))
    check(g_k.keys() == g_kp.keys() == g_p.keys(), "different leaves received gradients")

    rel_kp, _, cos_kp = compare_grads(g_k, g_kp)
    rel_p, rest_p, cos_p = compare_grads(g_k, g_p)
    log(f"[8 fp32 grads] 1 image, {len(g_k)} trainable leaves with gradients; loss "
        f"kernels {loss_k:.6f}, plain {loss_p:.6f}; kernel fwd+bwd vs kernel fwd + plain bwd: "
        f"worst leaf max|d| / max|g| {rel_kp:.3g} (tol {GRAD_REL:g}), min cosine {cos_kp:.8f}; "
        f"vs plain fwd+bwd: worst {rel_p:.3g} (tol {FLIP_REL:g}), worst outside each leaf's "
        f"worst channel {rest_p:.3g}, min cosine {cos_p:.8f} (tol {GRAD_COS})")
    check(loss_k == loss_kp, "the same forward gave two losses")
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), f"losses differ: {loss_k} vs {loss_p}")
    check(rel_kp <= GRAD_REL, f"backward kernel moves a gradient by {rel_kp} of its scale")
    check(rel_p <= FLIP_REL and cos_p >= GRAD_COS,
          f"gradients through the kernels differ from the plain versions: {rel_p}, {cos_p}")


def make_eval_set(root, images, rng, num_categories=80):
    """A synthetic COCO set made with numpy: uint8 noise images, each with 2-5
    filled ellipses whose boxes and masks (np.mgrid) are the ground truth,
    segmentations stored as RLE. Writes the annotation json under `root` and
    returns its path and the images by file name: evaluate_dataset reads
    them through its load_image, so no image file is written or decoded."""
    import numpy as np

    from detectorch_tpu_torch.eval import rle

    pics, imgs, anns = {}, [], []
    for h, w, count in images:
        yy, xx = np.mgrid[:h, :w] + 0.5
        for _ in range(count):
            image_id = len(imgs) + 1
            name = f"{image_id:06d}.png"
            im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for _ in range(rng.randint(2, 6)):
                bw, bh = rng.uniform(0.1, 0.5) * w, rng.uniform(0.1, 0.5) * h
                cx, cy = rng.uniform(bw / 2, w - bw / 2), rng.uniform(bh / 2, h - bh / 2)
                mask = ((xx - cx) / (bw / 2)) ** 2 + ((yy - cy) / (bh / 2)) ** 2 <= 1
                im[mask] = rng.randint(0, 256, 3)
                ys, xs = np.nonzero(mask)
                anns.append({
                    "id": len(anns) + 1, "image_id": image_id,
                    "category_id": int(rng.randint(1, num_categories + 1)),
                    "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
                             float(ys.max() - ys.min() + 1)],
                    "area": float(mask.sum()), "iscrowd": 0,
                    "segmentation": rle.encode(mask.astype(np.uint8)),
                })
            pics[name] = im
            imgs.append({"id": image_id, "file_name": name, "height": h, "width": w})
    ann = os.path.join(root, "instances_synth.json")
    with open(ann, "w") as f:
        json.dump({"images": imgs, "annotations": anns,
                   "categories": [{"id": c, "name": f"class{c}"}
                                  for c in range(1, num_categories + 1)]}, f)
    return ann, pics


def compare_results(a, b):
    """tests/test_engine.py's comparison of two engines' COCO results: per
    image the same number of detections; in score order the same classes,
    boxes within rtol 1e-4 / atol 1e-3, and equal mask RLEs. Returns the
    counts of what differs and the largest box difference."""
    import numpy as np

    diff = {"images": 0, "classes": 0, "boxes": 0, "masks": 0}
    max_box = 0.0
    for key in ("bbox", "segm"):
        ra = sorted(a[key], key=lambda r: (r["image_id"], -r["score"]))
        rb = sorted(b[key], key=lambda r: (r["image_id"], -r["score"]))
        ids_a, ids_b = [r["image_id"] for r in ra], [r["image_id"] for r in rb]
        if ids_a != ids_b:
            diff["images"] += 1
            continue
        for x, y in zip(ra, rb):
            diff["classes"] += x["category_id"] != y["category_id"]
            if key == "bbox":
                d = np.abs(np.subtract(x["bbox"], y["bbox"]))
                max_box = max(max_box, float(d.max()))
                diff["boxes"] += not np.allclose(x["bbox"], y["bbox"], rtol=1e-4, atol=1e-3)
            else:
                diff["masks"] += x["segmentation"] != y["segmentation"]
    return diff, max_box


def phase_eval(device, images=EVAL_IMAGES, batch=BATCH, cfg=None, test_cfg=None,
               parity_images=PARITY_IMAGES, card=""):
    """COCO evaluation through the port's entry points; returns the forward
    kernel's launch count in the timed run."""
    import collections
    import functools
    import math
    import tempfile

    import numpy as np
    import torch

    from detectorch_tpu_torch.config import PRESETS, TestConfig
    from detectorch_tpu_torch.data.coco import CocoDataset
    from detectorch_tpu_torch.eval import rle
    from detectorch_tpu_torch.checkpoint import caffe2_import as c2
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax
    from detectorch_tpu_torch.eval.engine import evaluate_dataset
    from detectorch_tpu_torch.models.detector import init_params
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_fwd

    cfg = cfg or PRESETS[PRESET]
    # random weights score every class near 1/81, under the default 0.05
    test_cfg = test_cfg or TestConfig(score_thresh=0.0, device_preprocess=True)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ann, pics = make_eval_set(root, images, np.random.RandomState(7))
        pkl = os.path.join(root, "model_final.pkl")
        c2.save_caffe2_pkl(params_from_jax(init_params(cfg, seed=0)), cfg, pkl)
        params = c2.fold_bn(c2.import_params(c2.load_caffe2_pkl(pkl), cfg))
        ds = CocoDataset(ann, root)
        roidb = ds.get_roidb(gt=False)
        shapes = {e.image_id: (e.height, e.width) for e in roidb}
        what = ", ".join(f"{c} at {h}x{w}" for h, w, c in images)
        log(f"[9 eval] {len(roidb)} images ({what}), {len(ds.coco.anns)} gt objects; "
            f"Detectron pkl of {os.path.getsize(pkl) / 2 ** 20:.1f} MiB written and read back; "
            f"set-up {time.perf_counter() - t0:.2f} s")

        def load_image(path):
            return pics[os.path.basename(path)]

        engines = {}
        run = functools.partial(evaluate_dataset, cfg, test_cfg, params, ds, verbose=False,
                                batch_size=batch, engines=engines, load_image=load_image,
                                device=device)
        # warm-up: one image of each shape, each a short batch of its bucket
        firsts = list({(e.height, e.width): e for e in reversed(roidb)}.values())
        t0 = time.perf_counter()
        run(roidb=firsts)
        log(f"[9 eval] warm-up over {len(firsts)} short batches: {time.perf_counter() - t0:.2f} s")
        roi_align_fwd.launches = 0
        t0 = time.perf_counter()
        bbox_stats, segm_stats, info = run(roidb=roidb)
        launches = roi_align_fwd.launches
        wall = time.perf_counter() - t0
        engines.clear()
        n_batches = sum(math.ceil(c / batch) for _, _, c in images)
        per_image = collections.Counter(r["image_id"] for r in info["bbox"])
        split = " ".join(f"{k}={v:.3f}s" for k, v in info["phase_seconds"].items())
        log(f"[9 eval] {cfg.name} compute={cfg.compute_dtype} batch={batch}, device "
            f"preprocess: {info['images_per_sec']:.2f} img/s end to end on {card or device} "
            f"(loop split: {split}); evaluate_dataset {wall:.2f} s with COCOeval; kernel "
            f"launches {launches} in {n_batches} batches")
        check(sorted(per_image) == sorted(shapes)
              and min(per_image.values()) >= test_cfg.detections_per_img,
              f"an image has fewer than {test_cfg.detections_per_img} detections: {per_image}")
        check(len(info["segm"]) == len(info["bbox"]), "masks and boxes differ in number")
        check(all(rle.decode(r["segmentation"]).shape == shapes[r["image_id"]]
                  for r in info["segm"]), "an RLE does not decode to its image's size")
        for name, stats in (("bbox", bbox_stats), ("segm", segm_stats)):
            check(stats is not None and len(stats) == 12 and bool(np.isfinite(stats).all()),
                  f"COCOeval {name} stats are not 12 finite numbers: {stats}")
        log(f"[9 eval] detections per image {min(per_image.values())}-{max(per_image.values())}; "
            f"{len(info['segm'])} masks, each of its image's size; 12 + 12 finite COCOeval "
            f"stats, bbox AP {bbox_stats[0]:.4f}, segm AP {segm_stats[0]:.4f} (random weights)")
        if device.type == "cuda":
            check(launches == 2 * n_batches,
                  f"RoIAlign kernel launched {launches} times in {n_batches} batches, "
                  "expected 2 each")

        # fp32, TF32 off, masks fetched in fp32: the batched engine's results
        # equal the single-image engine's. Random mask logits all sit within
        # rounding of the 0.5 threshold; a +-3 bias per class (confident
        # masks, as trained weights give) keeps a pixel comparison meaningful
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        bias = params["mask_fcn_logits_b"].clone()
        bias[0::2], bias[1::2] = 3.0, -3.0
        run32 = functools.partial(
            evaluate_dataset, cfg.replace(compute_dtype="float32"),
            test_cfg.replace(mask_fetch_dtype="float32"), {**params, "mask_fcn_logits_b": bias},
            ds, roidb=roidb[:parity_images], verbose=False, engines={}, load_image=load_image,
            device=device)
        _, _, single = run32(batch_size=1)
        _, _, batched = run32(batch_size=parity_images)
        diff, max_box = compare_results(single, batched)
        counts = sorted(collections.Counter(r["image_id"] for r in single["bbox"]).items())
        log(f"[9 eval] fp32 parity, first {parity_images} images, batched (batch "
            f"{parity_images}) vs single-image engine: detections per image {counts}; "
            f"differences {diff}; max|d box| {max_box:.3g} (rtol 1e-4, atol 1e-3)")
        check(not any(diff.values()), f"batched and single-image results differ: {diff}")
    return launches


def make_e2e_batch(rng, orig_sizes, blob_hw, target_size, max_size, gt_range, device):
    """An e2e training batch in the uint8 schema, made with numpy: uint8
    noise images of `orig_sizes`, padded to one raw bucket, with their
    resize tables and meta (``data.device_input``); per image a number of
    gts in `gt_range`, each a 12-gon with jittered radii whose tight box is
    the gt box, classes 1-80, and its raster wrt its own box at
    GT_RASTER_RES (``train.sampler.polys_to_mask_wrt_box``), padded to
    GT_PAD slots as the trainer pads them."""
    import numpy as np
    import torch

    from detectorch_tpu_torch.data.device_input import RAW_STRIDE, pack_tables_meta, prepare_raw
    from detectorch_tpu_torch.tools.train_fast import GT_PAD
    from detectorch_tpu_torch.train.e2e import GT_RASTER_RES
    from detectorch_tpu_torch.train.sampler import polys_to_mask_wrt_box

    raw_hw = (max(-(-h // RAW_STRIDE) * RAW_STRIDE for h, _ in orig_sizes),
              max(-(-w // RAW_STRIDE) * RAW_STRIDE for _, w in orig_sizes))
    out = {k: [] for k in ("raw", "tables", "meta", "gt_boxes", "gt_classes", "gt_valid",
                           "gt_masks", "gt_mask_valid")}
    for h, w in orig_sizes:
        raw, m = prepare_raw(rng.randint(0, 256, (h, w, 3)).astype(np.uint8), target_size,
                             max_size, buckets=(blob_hw,))
        padded = np.zeros(raw_hw + (3,), np.uint8)
        padded[: raw.shape[0], : raw.shape[1]] = raw
        tables, meta = pack_tables_meta(m)
        n = rng.randint(gt_range[0], gt_range[1] + 1)
        boxes = np.zeros((GT_PAD, 4), np.float32)
        masks = np.zeros((GT_PAD, GT_RASTER_RES, GT_RASTER_RES), np.uint8)
        for j in range(n):
            radius = rng.uniform(0.03, 0.3) * min(h, w)
            cx, cy = rng.uniform(radius, w - radius), rng.uniform(radius, h - radius)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 12))
            rad = radius * (0.6 + 0.4 * rng.rand(12))
            px, py = cx + rad * np.cos(ang), cy + rad * np.sin(ang)
            box = np.array([px.min(), py.min(), px.max(), py.max()])
            masks[j] = polys_to_mask_wrt_box([np.stack([px, py], 1).reshape(-1)], box,
                                             GT_RASTER_RES)
            boxes[j] = box * m["scale"]
        valid = np.arange(GT_PAD) < n
        for k, v in (("raw", padded), ("tables", tables), ("meta", meta), ("gt_boxes", boxes),
                     ("gt_classes", np.where(valid, rng.randint(1, 81, GT_PAD), 0).astype(np.int32)),
                     ("gt_valid", valid), ("gt_masks", masks), ("gt_mask_valid", valid)):
            out[k].append(v)
    return {k: torch.from_numpy(np.stack(v)).to(device) for k, v in out.items()}


# COCO-like landscape image sizes of phase 10's batch; all resize into the
# 832x1344 bucket at target size 800, max size 1333
E2E_SIZES = ((480, 640), (427, 640), (500, 750), (375, 500), (480, 640), (426, 640),
             (512, 683), (640, 853))
TRAIN_PRE, TRAIN_POST = 12000, 2000  # the reference's train counts


def profile_step(run, device, top=8):
    """One call of run() under torch.profiler: its host-clock time, the
    union of its kernels' device intervals (busy) and the idle share of the
    window, the host's cudaStreamSynchronize calls, and the `top` operators
    by the device time of their kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # the union of the intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    syncs = sum(e.name == "cudaStreamSynchronize" for e in events)

    # operators (not their kernels, which would count the time twice) by
    # the device time of the kernels they launch
    ops = [a for a in prof.key_averages() if a.device_type == DeviceType.CPU]
    by_name = sorted(ops, key=lambda a: a.self_device_time_total, reverse=True)[:top]
    check(busy > 0, "the profiler saw no device time")
    return {"wall_ms": wall, "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / 1e3 / wall,
            "syncs": syncs,
            "top": [(a.key[:48], a.self_device_time_total / 1e3) for a in by_name]}


def phase_e2e_train(device, height=HEIGHT, width=WIDTH, cfg=None, sizes=E2E_SIZES,
                    target_size=800, max_size=1333, rois_per_image=TRAIN_ROIS, pre=TRAIN_PRE,
                    post=TRAIN_POST, gt_range=(3, 20), card=""):
    """The e2e Mask R-CNN step through both kernels, in the uint8 schema;
    returns the launch counts of the three timed steps and the step rate."""
    import numpy as np
    import torch

    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.config import PRESETS, SamplerConfig, SolverConfig
    from detectorch_tpu_torch.models.detector import init_params
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import (
        roi_align_bwd,
        roi_align_fwd,
        roi_tile_lists,
    )
    from detectorch_tpu_torch.ops.fpn_levels import map_rois_to_fpn_levels
    from detectorch_tpu_torch.train.e2e import e2e_losses, make_e2e_train_step, torch_uniforms
    from detectorch_tpu_torch.train.solver import apply_update
    from detectorch_tpu_torch.train.train_step import device_images

    cfg = cfg or PRESETS[PRESET]
    batch = len(sizes)
    t0 = time.perf_counter()
    params = params_to_device(params_from_jax(init_params(cfg, seed=0)), device)
    # random weights on one fixed batch: as in phase 7, 1e-4 makes the loss fall
    solver = SolverConfig(base_lr=1e-4, warmup_iters=0)
    sampler = SamplerConfig(rois_per_image=rois_per_image)
    init_state, make_step = make_e2e_train_step(
        cfg, solver, sampler, seed=0, train_pre_nms=pre, train_post_nms=post, train_mask=True,
        device_input=True, blob_hw=(height, width), roi_align_impl="pallas-slab")
    state, opt = init_state(params)
    del params
    step = make_step(opt)
    fixed = make_e2e_batch(np.random.RandomState(10), sizes, (height, width), target_size,
                           max_size, gt_range, device)
    n_gt = fixed["gt_valid"].sum(dim=1).tolist()
    log(f"[10 e2e] {cfg.name} compute={cfg.compute_dtype} batch={batch} in {height}x{width}, "
        f"uint8 input (raw {tuple(fixed['raw'].shape[1:3])}), gts per image {n_gt} of "
        f"{fixed['gt_valid'].shape[1]} slots, RPN {pre} -> {post} per level, {rois_per_image} "
        f"rois per image: params + batch in {time.perf_counter() - t0:.2f} s")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def run():
        nonlocal state
        state, metrics = step(state, fixed)
        values = {k: float(v) for k, v in metrics.items()}
        sync()
        check(all(np.isfinite(v) for v in values.values()), f"non-finite metrics {values}")
        return values

    t0 = time.perf_counter()
    losses = [run()["loss"]]
    log(f"[10 e2e] warm-up step: {time.perf_counter() - t0:.3f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    roi_align_fwd.launches = roi_align_bwd.launches = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(run()["loss"])
        times.append(time.perf_counter() - t0)
    launches = {"roi_align_fwd": roi_align_fwd.launches, "roi_align_bwd": roi_align_bwd.launches}
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else 0.0

    # the fifth step in stages, synchronised after each
    marks = [("start", time.perf_counter())]

    def mark(name):
        sync()
        marks.append((name, time.perf_counter()))

    images = device_images(fixed, (height, width))
    mark("device preprocess")
    draw = torch_uniforms(0)
    total, metrics, sampled = e2e_losses(
        state.params, cfg, sampler, images, fixed["gt_boxes"], fixed["gt_classes"],
        fixed["gt_valid"], fixed["meta"][:, 2:5],
        lambda na, nc: draw(state.step, batch, na, nc, device), train_pre_nms=pre,
        train_post_nms=post, extras={"gt_masks": fixed["gt_masks"],
                                     "gt_mask_valid": fixed["gt_mask_valid"]}, stage=mark)
    loss = total.mean()
    loss.backward()
    mark("backward")
    apply_update(opt, state.step, solver)
    mark("update")
    stages = [(name, (t - marks[i][1]) * 1e3) for i, (name, t) in enumerate(marks[1:])]
    last = {k: float(v.detach().mean()) for k, v in metrics.items()}
    last["loss"] = float(loss.detach())
    check(all(np.isfinite(v) for v in last.values()), f"non-finite metrics {last}")
    check({"loss_cls", "loss_bbox", "loss_rpn_cls", "loss_rpn_bbox", "accuracy",
           "loss_mask"} <= set(last), f"metrics {sorted(last)}")
    losses.append(last["loss"])

    # how the sampled rois crowd the backward kernel's tiles
    fg_rows = int(round(sampler.fg_fraction * rois_per_image))
    shapes = [(batch, height // s, width // s, cfg.fpn.channels) for s in (4, 8, 16, 32)]
    crowd = []
    for rows, pooled in ((rois_per_image, cfg.roi_size), (fg_rows, cfg.mask.roi_size)):
        rois = sampled.rois[:, :rows].reshape(-1, 4).float().contiguous()
        levels = (map_rois_to_fpn_levels(rois) - 2).to(torch.int32).contiguous()
        bidx = torch.arange(batch, dtype=torch.int32, device=device).repeat_interleave(rows)
        starts, _ = roi_tile_lists(shapes, rois, bidx, levels, cfg.fpn_spatial_scales, pooled,
                                   pooled)
        crowd.append(int((starts[1:] - starts[:-1]).max()))
    n_fg = (sampled.labels > 0).sum(dim=1).tolist()

    profile = profile_step(run, device) if device.type == "cuda" else None

    rate = batch * len(times) / sum(times)
    log(f"[10 e2e] steps: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms -> "
        f"{sum(times) / len(times) * 1e3:.1f} ms/step, {rate:.2f} img/s on {card or device}; "
        f"peak memory {peak:.2f} GiB; kernel launches in 3 steps {launches}")
    log(f"[10 e2e] step 5 in stages (ms): "
        + ", ".join(f"{name} {ms:.1f}" for name, ms in stages)
        + f"; total {sum(ms for _, ms in stages):.1f}")
    log(f"[10 e2e] step 5 sample: fg rois per image {n_fg}, valid rois per image "
        f"{sampled.valid.sum(dim=1).tolist()}; most rois on one backward tile: {crowd[0]} (box, "
        f"{cfg.roi_size}x{cfg.roi_size}), {crowd[1]} (mask rows, "
        f"{cfg.mask.roi_size}x{cfg.mask.roi_size})")
    log(f"[10 e2e] loss over 5 steps on one batch: {', '.join(f'{v:.4f}' for v in losses)}; "
        f"step 5 {', '.join(f'{k} {v:.4f}' for k, v in last.items())}")
    if profile:
        log(f"[10 e2e] step 6 under torch.profiler: {profile['wall_ms']:.1f} ms, device busy "
            f"{profile['busy_ms']:.1f} ms, idle share {profile['idle_share']:.3f}; "
            f"{profile['syncs']} cudaStreamSynchronize calls; most device time: "
            + ", ".join(f"{name} {ms:.2f} ms" for name, ms in profile["top"]))
    if device.type == "cuda":
        check(launches == {"roi_align_fwd": 6, "roi_align_bwd": 6},
              f"kernel launches {launches} in 3 steps, expected 2 forward + 2 backward each")
    check(losses[-1] < losses[0], f"loss did not fall over 5 steps: {losses}")
    return launches, rate


def phase_e2e_fp32_grads(device, height=HEIGHT, width=WIDTH, cfg=None, sizes=E2E_SIZES[:1],
                         target_size=800, max_size=1333, rois_per_image=TRAIN_ROIS,
                         pre=TRAIN_PRE, post=TRAIN_POST, gt_range=(3, 20)):
    """One image of the fp32 e2e step with one fixed set of uniforms:
    gradients through the kernels (K), through the kernel forward and the
    plain backward (KP), and through both plain versions (P), held as in
    phase 8; the three runs sample the same rois."""
    import functools

    import numpy as np
    import torch

    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.config import PRESETS, SamplerConfig, SolverConfig
    from detectorch_tpu_torch.models.detector import init_params
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_fwd
    from detectorch_tpu_torch.ops.roi_align import (
        multilevel_roi_align,
        multilevel_roi_align_backward,
    )
    from detectorch_tpu_torch.ops.roi_align_fused import roi_align_fused
    from detectorch_tpu_torch.train.e2e import e2e_losses, torch_uniforms
    from detectorch_tpu_torch.train.train_step import device_images, make_init_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (cfg or PRESETS[PRESET]).replace(compute_dtype="float32")
    params = params_to_device(params_from_jax(init_params(cfg, seed=0)), device)
    b = make_e2e_batch(np.random.RandomState(11), sizes, (height, width), target_size, max_size,
                       gt_range, device)
    images = device_images(b, (height, width))
    sampler = SamplerConfig(rois_per_image=rois_per_image)
    init_state = make_init_state(SolverConfig())
    drawn = {}

    def uniforms(n_anchors, n_cand):  # drawn once, the same for all three runs
        if not drawn:
            drawn.update(torch_uniforms(11)(0, len(sizes), n_anchors, n_cand, device))
        return drawn

    def grads(roi_align):
        state, _ = init_state(params)
        total, _, sampled = e2e_losses(
            state.params, cfg, sampler, images, b["gt_boxes"], b["gt_classes"], b["gt_valid"],
            b["meta"][:, 2:5], uniforms, train_pre_nms=pre, train_post_nms=post,
            extras={"gt_masks": b["gt_masks"], "gt_mask_valid": b["gt_mask_valid"]},
            roi_align=roi_align)
        total.sum().backward()
        return float(total.detach().sum()), {k: v.grad for k, v in state.params.items()
                                             if v.grad is not None}, sampled

    loss_k, g_k, s_k = grads(roi_align_fused)
    loss_kp, g_kp, s_kp = grads(functools.partial(roi_align_fused, fwd=roi_align_fwd,
                                                  bwd=multilevel_roi_align_backward))
    loss_p, g_p, s_p = grads(functools.partial(roi_align_fused, fwd=multilevel_roi_align,
                                               bwd=multilevel_roi_align_backward))
    check(g_k.keys() == g_kp.keys() == g_p.keys(), "different leaves received gradients")
    same = all(torch.equal(s_k.rois, s.rois) and torch.equal(s_k.labels, s.labels)
               and torch.equal(s_k.valid, s.valid) for s in (s_kp, s_p))
    rel_kp, _, cos_kp = compare_grads(g_k, g_kp)
    rel_p, rest_p, cos_p = compare_grads(g_k, g_p)
    log(f"[11 e2e fp32 grads] {len(sizes)} image, {len(g_k)} trainable leaves with gradients, "
        f"{int((s_k.labels > 0).sum())} fg of {int(s_k.valid.sum())} sampled rois, the same "
        f"rois and labels in all three runs: {same}; loss kernels {loss_k:.6f}, plain "
        f"{loss_p:.6f}; kernel fwd+bwd vs kernel fwd + plain bwd: worst leaf max|d| / max|g| "
        f"{rel_kp:.3g} (tol {GRAD_REL:g}), min cosine {cos_kp:.8f}; vs plain fwd+bwd: worst "
        f"{rel_p:.3g} (tol {FLIP_REL:g}), worst outside each leaf's worst channel "
        f"{rest_p:.3g}, min cosine {cos_p:.8f} (tol {GRAD_COS})")
    check(same, "the runs sampled different rois or labels")
    check("rpn_cls_logits_fpn2_w" in g_k, "the RPN head received no gradient")
    check(loss_k == loss_kp, "the same forward gave two losses")
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), f"losses differ: {loss_k} vs {loss_p}")
    check(rel_kp <= GRAD_REL, f"backward kernel moves a gradient by {rel_kp} of its scale")
    check(rel_p <= FLIP_REL and cos_p >= GRAD_COS,
          f"gradients through the kernels differ from the plain versions: {rel_p}, {cos_p}")


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
    infer_launches, _, params = phase_main_path(device, card=smi)
    phase_fp32_parity(device, params)
    del params
    bwd_summary = phase_bwd_kernel(device)
    train_launches, _ = phase_train(device, card=smi)
    phase_fp32_grads(device)
    eval_launches = phase_eval(device, card=smi)
    e2e_launches, _ = phase_e2e_train(device, card=smi)
    phase_e2e_fp32_grads(device)
    source = "detectorch_tpu_torch/csrc"
    replaces = "detectorch_tpu/ops/pallas/roi_align_kernel.py"
    kernels = [{
        "name": "roi_align_fwd",
        "route": "cuda",
        "source": f"{source}/roi_align_fwd.cu",
        "replaces": f"{replaces}:164",
        "launches": e2e_launches["roi_align_fwd"],
        "launches_by_path": {"inference": infer_launches,
                             "training": train_launches["roi_align_fwd"],
                             "eval": eval_launches,
                             "e2e_training": e2e_launches["roi_align_fwd"]},
        "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"],
        "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"],
        "bound_by": summary["bound_by"],
        "library_ms": None,  # no PyTorch call computes caffe2 RoIAlign
        "calls": summary["calls"],
    }, {
        "name": "roi_align_bwd",
        "route": "cuda",
        "source": f"{source}/roi_align_bwd.cu",
        "replaces": f"{replaces}:489",
        "launches": e2e_launches["roi_align_bwd"],
        "launches_by_path": {"training": train_launches["roi_align_bwd"],
                             "e2e_training": e2e_launches["roi_align_bwd"]},
        "max_abs_err": bwd_summary["max_abs_err"],
        "ms": bwd_summary["ms"],
        "plain_ms": bwd_summary["plain_ms"],
        "bound_ms": bwd_summary["bound_ms"],
        "bound_by": bwd_summary["bound_by"],
        "library_ms": None,  # nor its feature gradient
        "calls": bwd_summary["calls"],
    }]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
     phase 8, and the same sampled rois and labels in all three runs;
 12. the C4 family, e2e_mask_rcnn_R-50-C4_2x, from here on at batch 8 and
     832x1344 (c4 is 52x84x1024), with c4_weights: both kernels at the C4
     call's shapes (one level at 1/16, sampling_ratio 0 with max_grid 8,
     14x14 bins; 1000 and 108 rois per image forward, 512 and 128 backward;
     random and clustered rois; bf16 and fp32) against the plain separable
     form on the card (JAX's two-matmul formulation, fp32 cuBLAS), within
     1e-5 of max|plain|, the backward's launches bitwise equal and its bf16
     the fp32 rounded once, with times, bounds, shares and the longest
     backward tile list;
 13. C4 inference (RPN 6000 -> 1000, 100 + 8 detection slots): a warm-up
     and three timed requests with peak memory and launches, one request
     split by stage, 2 images in fp32 with the kernels against the
     separable form; then two R-101-FPN requests (e2e_mask_rcnn_R-101-FPN_2x);
 14. C4 evaluation of phase 9's 36 images through evaluate_dataset, the C4
     Detectron pkl written and read back, with the batched-vs-single fp32
     parity (near-tied scores paired in either order);
 15. the C4 training steps: make_train_step with masks on host-sampled rois
     and make_e2e_train_step with masks from uint8 input (12000 -> 2000),
     each as phases 7 and 10 (ms/step, img/s, peak memory, launches, the
     loss over 5 steps, the most rois on one backward tile);
 16. one image of the C4 training step in fp32, held as phase 8;
 17. Keypoint R-CNN, e2e_keypoint_rcnn_R-50-FPN_1x, from here on at full
     width and depth (8 convs of 512, 17 keypoints, 56x56 heatmaps), bf16,
     batch 8, 832x1344, init_params(seed 0): a warm-up and three timed
     requests (img/s, peak memory, 2 forward launches each), one request
     split by stage (backbone + neck, RPN + proposals, box RoIAlign +
     fc6/fc7, postprocess, keypoint RoIAlign, keypoint trunk + deconv +
     upsample, decode), the forward kernel on that request's keypoint call
     against the plain version (error, time, bound, share), and 2 images in
     fp32 with the kernel against the plain RoIAlign: heatmaps, argmax bins
     (near-ties aside), x/y, logits and probabilities within tolerance;
 18. keypoint evaluation of 24 person-keypoints images (480x640, made by the
     port's data/synth copy) through evaluate_dataset, batch 8, on-device
     preprocessing: img/s and its split, 10 finite OKS stats, 2 launches per
     batch, then the batched engine against the single-image engine in fp32
     on detections and keypoints;
 19. the host-sampled keypoint training step (512 rois and 128 keypoint rows
     per image, 5 steps: ms/step, img/s, peak memory, the forward /
     backward / update split, 2 + 2 launches per step, the loss lower after
     5 steps), then the backward kernel on those 128 rows per image against
     the plain version (error, time, bound, share);
 20. the e2e keypoint step from uint8 input (RPN 12000 -> 2000, 512 rois,
     gt keypoints inside the gt boxes), as phase 10 with a keypoint stage;
 21. one image of the keypoint training step in fp32, held as phase 8;
 22. the parallel paths from here on (``parallel/mesh``): phase 10's e2e
     step through init_distributed_from_env and make_mesh on a one-rank
     NCCL group (torchrun's environment, a file:// rendezvous): its metrics
     over 4 steps equal the step's without a mesh (deterministic cuDNN, rtol
     2e-4), its ms/step beside the no-mesh step's and phase 10's, and the
     gradients' all-reduce alone, in one flat bucket and leaf by leaf;
 23. two ranks on the one card over gloo (NCCL refuses two ranks on one
     device; ``parallel/launch.run_ranks``), fp32 with TF32 off, against
     world 1 computed here first: the e2e step at global batch 8 (4 images
     per rank): each rank's sampled rois, labels and gt indices equal world
     1's for its rows, the global metrics within 2e-4, both kernels launched
     on each rank; one step at global batch 2: the momentum equal to world
     1's mean of the two images' gradients (one ReLU-flip channel per
     leaf allowed, as phase 8);
 24. on the same ranks: batched inference at 832x1344 in fp32 over data 2
     and over model 2 (fc6/fc7 split), 2 images, against the rank's rows
     run with the whole params (``parallel.dryrun.compare_outputs``); then
     evaluate_dataset on the mesh over phase 9's 36 images at global batch
     8: img/s per rank in bf16 (two processes sharing one card: not a
     scaling figure), and in fp32 the results equal world 1's;
 25. dryrun_multichip(2): data 1 x model 2 on the card, the e2e Mask R-CNN
     step at JAX's reduced counts and sharded inference at 416x672 held to
     one process;
 26. the demo and the host utilities: the native RLE (built in phase 2 with
     the host C++ compiler) against its numpy plain version on phase 9's
     data: the paste encode of 800 masks of one batch of each orientation
     through segm_results (strings equal byte for byte, both timed) and
     COCOeval's segm IoU over phase 9's results (matrices equal), beside
     phase 9's finalize seconds; then tools/demo.main in-process on a
     480x640 PNG of the port's data/synth, for e2e_keypoint_rcnn_R-50-FPN_1x
     and e2e_mask_rcnn_R-50-FPN_2x, from a Detectron pkl of init_params(seed
     0) with confident classes and +-3 mask / +3 keypoint biases, --thresh
     0.5: 2 forward and 0 backward launches; then InferenceEngine.run_image
     on the same image (a warm request's ms): the demo's file equal pixel
     for pixel to vis_one_image of its result, with
     a mask or a skeleton drawn; utils/profiling.trace around a demo request
     (the forward kernel's events in the trace) and device_timer of phase
     4's request, serial and pipelined; utils/debug.checked around the
     flagship request (passes), with one NaN pixel (raises ValueError), and
     assert_finite_tree on its outputs;
 27. production AP: tools/production_ap on e2e_mask_rcnn_R-50-FPN_2x,
     e2e_faster_rcnn_R-50-FPN_2x, e2e_mask_rcnn_R-50-C4_2x and
     e2e_keypoint_rcnn_R-50-FPN_1x, with probe weights that the card fits
     (tools/probe_weights) on the port's data/synth sets (24 images at
     224x288; 16 person-keypoints images): evaluate_dataset at each rung of
     the ladder (1 fp32 plain path on CPU tensors, 2 fp32 through the
     kernels with TF32 off, 3 + bf16 compute, 4 + the 832x1344 buckets,
     5 + device_preprocess, 6 + the batched engine at batch 4 with the bf16
     mask fetch; rows 1, 2 and 6 on C4 and keypoint, to keep the phase near
     150 s): the 12 COCO stats of each task, every one finite, box AP
     above 0.05 in every row, row 2 within 0.01 of row 1 on each task's
     AP@[.5:.95] (rows 3-6 printed, not bounded), and the forward kernel
     launched once per request for the box call and once more for the mask
     or keypoint call in rows 2-6, never in row 1, the backward never.
 28. the measurement tools (detectorch_tpu_torch/tools), in process:
     tools/bench at batch 8 with 5 requests (2 forward launches each), and
     with BENCH_MODE=train, the Fast R-CNN step (1 forward + 1 backward a
     step); tools/profile_e2e_train with masks at 5 steps (2 + 2 a step);
     tools/bench_e2e on 48 synthetic 640x960 JPGs at batch 8 (2 forward a
     batch); tools/profile_stages on the flagship and on C4 (2 forward a
     request, the staged outputs equal to the fused request's bit for bit);
     tools/profile_mfu: the chained bf16 matmul rate, the FLOPs of the
     flagship request (equal to the closed-form count of its conv and
     linear layers plus roi_align_work's operations), of the Fast R-CNN
     step and of the three e2e steps, and the MFU of phase 4's and this
     phase's rates and steps; every rate finite and above 0, vs_baseline
     null. Phases 13 and 17 split their requests by stage through
     tools/profile_stages too.

The line before the last is a JSON summary of the kernels (their times and
bounds are those of the random bf16 7x7 call; "calls" lists every timed
call, FPN, C4 and the keypoint calls; "launches" counts phase 10's three steps,
"launches_by_path" each path's timed run, per rank for phases 23-25, the
demo's counted run for "demo" and "demo_keypoint", and each row of phase 27
by preset under "production_ap"), with phases 22-24's times under
"parallel", the native RLE's under "rle_native", the demo's and
device_timer's under "demo", phase 27's rows and seconds under
"production_ap", and phase 28's tool lines under "bench" (its launch
counts, each tool's whole call from counts set to 0, in
"launches_by_path"); the line before it nvidia-smi's
name and power limit; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1 and
prints no result.
"""

from __future__ import annotations

import contextlib
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
# fp32 keypoint branch, kernel vs plain RoIAlign on the same boxes: roi
# features ~1e-7 apart in relative terms, carried through 8 convs of 512;
# heatmap logits within KP_HEAT_REL of their largest, x/y equal (to fp32
# rounding) where the argmax bins agree, the spatial softmax's probability
# (a sum over 3136 bins) within KP_PROB_REL
KP_HEAT_REL, KP_XY_ATOL, KP_PROB_REL = 1e-4, 1e-3, 1e-3
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


def fwd_bound(feats, rois, bidx, levels, scales, pooled):
    """The forward's least time: the touched feature bytes read once, rois
    and indices read, the fp32 output written, or its operations."""
    from detectorch_tpu_torch.tools.measure import roi_align_work, roofline

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

    from detectorch_tpu_torch.tools.measure import roi_align_work, roofline

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
    """Both kernels (one nvcc each) and the native RLE (the host C++
    compiler), started together; returns the RLE library's build seconds."""
    from detectorch_tpu_torch.eval import rle_native
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd, roi_align_fwd

    def build_rle():
        t0 = time.perf_counter()
        rle_native.library.load()
        return rle_native.library.path, time.perf_counter() - t0

    t0 = time.perf_counter()
    kernels = (roi_align_fwd, roi_align_bwd)
    with ThreadPoolExecutor(len(kernels) + 1) as pool:
        rle_build = pool.submit(build_rle)
        paths = list(pool.map(lambda k: k.build(), kernels))
        rle_path, rle_s = rle_build.result()
    log(f"[2 build] {', '.join(os.path.relpath(p, REPO) for p in paths)} in "
        f"{time.perf_counter() - t0:.2f} s; {os.path.relpath(rle_path, REPO)} "
        f"({rle_native.compiler()} {' '.join(rle_native.CXX_FLAGS)}) in {rle_s:.2f} s")
    for kernel in kernels:
        for line in kernel.build_log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"          ptxas: {line.strip()}")
    return rle_s


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
    }
    check((out.masks is None) != cfg.use_mask, "masks present without the mask branch or absent")
    check((out.keypoints is None) == (cfg.keypoint is None),
          "keypoints present without the keypoint branch or absent")
    if cfg.use_mask:
        m = cfg.mask.resolution
        shapes["masks"] = (out.masks, (batch, k, m, m))
    if cfg.keypoint is not None:
        shapes["keypoints"] = (out.keypoints, (batch, k, cfg.keypoint.num_keypoints, 4))
    for name, (t, shape) in shapes.items():
        check(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"{name} not finite")
    if cfg.use_mask:
        check(bool(((out.masks >= 0) & (out.masks <= 1)).all()),
              "mask probabilities outside [0, 1]")
    if cfg.keypoint is not None:
        prob = out.keypoints[..., 3]
        check(bool(((prob > 0) & (prob <= 1)).all()), "keypoint probabilities outside (0, 1]")
        # every decoded keypoint lies in its detection's box (widths >= 1 px)
        b = d.boxes[..., None, :]
        kx, ky = out.keypoints[..., 0], out.keypoints[..., 1]
        inside = ((kx >= b[..., 0]) & (kx <= torch.maximum(b[..., 2], b[..., 0] + 1))
                  & (ky >= b[..., 1]) & (ky <= torch.maximum(b[..., 3], b[..., 1] + 1)))
        check(bool(inside[d.valid].all()), "a decoded keypoint lies outside its box")
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
                    test_cfg=None, requests=3, card="", tag="4 main", params=None):
    import torch

    from detectorch_tpu_torch.config import PRESETS, TestConfig
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.models.detector import init_params, make_inference_fn
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_fwd

    cfg = cfg or PRESETS[PRESET]
    test_cfg = test_cfg or TestConfig()
    t0 = time.perf_counter()
    if params is None:
        params = params_to_device(params_from_jax(init_params(cfg, seed=0)), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    batch_args = _batch(gen, batch, height, width, device)
    log(f"[{tag}] {cfg.name} compute={cfg.compute_dtype} batch={batch} {height}x{width}: "
        f"params + inputs in {time.perf_counter() - t0:.2f} s")
    fwd = make_inference_fn(cfg, test_cfg)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    fwd(params, *batch_args)
    sync()
    log(f"[{tag}] warm-up request: {time.perf_counter() - t0:.3f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    roi_align_fwd.launches = 0
    times = []
    for _ in range(requests):
        t0 = time.perf_counter()
        out = fwd(params, *batch_args)
        sync()
        times.append(time.perf_counter() - t0)
    launches = roi_align_fwd.launches
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else 0.0
    n_valid, n_rois = check_outputs(out, cfg, test_cfg, batch)
    total = sum(times)
    log(f"[{tag}] requests: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms -> "
        f"{batch * requests / total:.2f} img/s on {card or device}; valid rois per image {n_rois}; "
        f"valid detections per image {n_valid}; kernel launches {launches}; peak memory "
        f"{peak:.2f} GiB")
    if device.type == "cuda":
        check(launches == 2 * requests,
              f"RoIAlign kernel launched {launches} times in {requests} requests, expected 2 each")
    return launches, batch * requests / total, params


def plain_roi_align(cfg):
    """The plain RoIAlign of cfg's call sites: the gather form over the FPN
    pyramid, the separable form (cuBLAS matmuls) over the C4 map."""
    from detectorch_tpu_torch.ops.roi_align import multilevel_roi_align, roi_align_matmul

    return multilevel_roi_align if cfg.use_fpn else roi_align_matmul


def phase_fp32_parity(device, params, height=HEIGHT, width=WIDTH, cfg=None, test_cfg=None,
                      tag="5 fp32", images=1):
    """`images` images in fp32: the whole path with the kernel vs the plain
    RoIAlign."""
    import torch

    from detectorch_tpu_torch.config import PRESETS, TestConfig
    from detectorch_tpu_torch.models.detector import (
        backbone_features,
        make_inference_fn,
        mask_branch,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (cfg or PRESETS[PRESET]).replace(compute_dtype="float32")
    test_cfg = test_cfg or TestConfig()
    plain = plain_roi_align(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    args = _batch(gen, images, height, width, device)
    out_k = make_inference_fn(cfg, test_cfg)(params, *args)
    out_p = make_inference_fn(cfg, test_cfg, roi_align=plain)(params, *args)
    check_outputs(out_k, cfg, test_cfg, images)
    check(torch.equal(out_k.rois, out_p.rois) and torch.equal(out_k.roi_valid, out_p.roi_valid),
          "rois differ between kernel and plain runs")
    cls_err = (out_k.cls_scores - out_p.cls_scores).abs().max().item()
    delta_err = (out_k.bbox_deltas - out_p.bbox_deltas).abs().max().item()
    # masks and keypoints of the same detections through both RoIAlign
    # versions (the detection top-K of random weights sits on near-ties)
    with torch.inference_mode():
        feats = backbone_features(params, cfg, args[0])
        d = out_k.detections
        branch = ""
        if cfg.use_mask:
            masks_p = mask_branch(params, cfg, feats, d.boxes, d.classes, args[1],
                                  roi_align=plain)
            mask_err = (out_k.masks - masks_p).abs().max().item()
            branch = f"max|d masks| {mask_err:.3g} (tol {MASK_ATOL:g}); "
        if cfg.keypoint is not None:
            kp = compare_keypoints(params, cfg, feats, d.boxes, args[1], plain)
            branch = (f"keypoint heatmaps max|d| {kp['heat_err']:.3g} = "
                      f"{kp['heat_err'] / kp['heat_scale']:.3g} of max|plain| "
                      f"{kp['heat_scale']:.3g} (tol {KP_HEAT_REL:g}); argmax bins equal at "
                      f"{kp['same']} of {kp['count']} keypoints, the rest near-ties (plain "
                      f"max - plain at the kernel's bin <= {kp['tie_gap']:.3g}); x/y max|d| "
                      f"{kp['xy_err']:.3g} px where the bins are equal (tol {KP_XY_ATOL:g}), "
                      f"logits {kp['logit_err']:.3g}, probabilities rel {kp['prob_rel']:.3g} "
                      f"(tol {KP_PROB_REL:g}); ")
    same_dets = torch.equal(out_k.detections.classes, out_p.detections.classes) \
        and torch.equal(out_k.detections.valid, out_p.detections.valid)
    log(f"[{tag}] {images} image(s), kernel vs plain RoIAlign: rois equal; "
        f"max|d cls_scores| {cls_err:.3g} (tol {CLS_ATOL:g}), "
        f"max|d bbox_deltas| {delta_err:.3g} (tol {DELTA_ATOL:g}), {branch}"
        f"same detections selected: {same_dets}; "
        f"valid detections {int(out_k.detections.valid.sum())}")
    check(cls_err <= CLS_ATOL, f"cls_scores differ by {cls_err}")
    check(delta_err <= DELTA_ATOL, f"bbox_deltas differ by {delta_err}")
    if cfg.use_mask:
        check(mask_err <= MASK_ATOL, f"masks differ by {mask_err}")
    if cfg.keypoint is not None:
        check_keypoints(kp)


def compare_keypoints(params, cfg, feats, boxes, im_scale, plain):
    """The keypoints of the same boxes through the kernel and through the
    plain RoIAlign: heatmap logits, argmax bins, then the decode. Where the
    argmax bins differ, the plain heatmap's value at the kernel's bin must
    lie within the heatmaps' tolerance of its maximum (a near-tie: bilinear
    upsampling makes neighbouring bins close)."""
    import torch

    from detectorch_tpu_torch.models.detector import keypoint_heatmaps
    from detectorch_tpu_torch.ops.keypoints import heatmaps_to_keypoints

    heat_k = keypoint_heatmaps(params, cfg, feats, boxes, im_scale)
    heat_p = keypoint_heatmaps(params, cfg, feats, boxes, im_scale, plain)
    n, s, _, p = heat_p.shape
    flat_k, flat_p = heat_k.reshape(n, s * s, p), heat_p.reshape(n, s * s, p)
    bin_k, bin_p = flat_k.argmax(dim=1), flat_p.argmax(dim=1)
    same = bin_k == bin_p
    gap = flat_p.amax(dim=1) - torch.gather(flat_p, 1, bin_k[:, None, :])[:, 0]
    dec_k = heatmaps_to_keypoints(heat_k, boxes.reshape(-1, 4))
    dec_p = heatmaps_to_keypoints(heat_p, boxes.reshape(-1, 4))
    return {
        "heat_err": (heat_k - heat_p).abs().max().item(),
        "heat_scale": heat_p.abs().max().item(),
        "count": same.numel(), "same": int(same.sum()),
        "tie_gap": gap.max().item(),
        "xy_err": (dec_k[..., :2] - dec_p[..., :2]).abs().amax(dim=-1)[same].max().item(),
        "logit_err": (dec_k[..., 2] - dec_p[..., 2]).abs().max().item(),
        "prob_rel": ((dec_k[..., 3] - dec_p[..., 3]).abs() / dec_p[..., 3]).max().item(),
    }


def check_keypoints(kp):
    tol = KP_HEAT_REL * kp["heat_scale"]
    check(kp["heat_err"] <= tol, f"keypoint heatmaps differ by {kp['heat_err']}")
    check(kp["tie_gap"] <= 2 * tol, f"an argmax bin moved by more than a near-tie: {kp}")
    check(kp["same"] >= 0.99 * kp["count"], f"argmax bins moved at many keypoints: {kp}")
    check(kp["xy_err"] <= KP_XY_ATOL, f"keypoint x/y differ by {kp['xy_err']} px")
    check(kp["logit_err"] <= tol, f"keypoint logits differ by {kp['logit_err']}")
    check(kp["prob_rel"] <= KP_PROB_REL, f"keypoint probabilities differ by {kp['prob_rel']}")


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
                     mask_res, device, keypoints=0):
    """A training batch built with numpy from synthetic roidb entries: gt
    boxes, jittered and random proposals, the port's bbox regression
    targets and the port's copy of the roi sampler; mask targets are
    ellipses rasterised in each fg roi's frame. With `keypoints` > 0, each
    gt carries that many keypoints inside its box (a fifth unlabelled), and
    the sampler bins them into kp_labels/kp_valid over the first
    `mask_rows` rows in place of the mask targets."""
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
    extra = ("kp_labels", "kp_valid") if keypoints else ("mask_targets", "mask_valid")
    out = {k: [] for k in keys + extra}
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
        if keypoints:
            u = rng.uniform(0, 1, (n_gt, keypoints, 2))
            kxy = gt[:, None, :2] + u * (gt[:, None, 2:] - gt[:, None, :2])
            vis = np.where(rng.rand(n_gt, keypoints) < 0.2, 0, 2)
            entry.gt_keypoints = np.concatenate([kxy, vis[..., None]], -1).astype(np.float32)
        add_bbox_regression_targets([entry])
        blobs = sample_rois(entry, 1.0, rng, SamplerConfig(rois_per_image=rois_per_image),
                            num_classes)
        for k in keys:
            out[k].append(blobs[k])
        if keypoints:
            out["kp_labels"].append(blobs["kp_labels"][:mask_rows])
            out["kp_valid"].append(blobs["kp_valid"][:mask_rows])
            continue
        fg = blobs["labels"][:mask_rows] > 0
        c = rng.uniform(-0.15, 0.15, (mask_rows, 2, 1, 1))
        r = rng.uniform(0.2, 0.5, (mask_rows, 2, 1, 1))
        ellipse = ((yy - c[:, 0]) / r[:, 0]) ** 2 + ((xx - c[:, 1]) / r[:, 1]) ** 2 <= 1
        out["mask_targets"].append((ellipse & fg[:, None, None]).astype(np.float32))
        out["mask_valid"].append(fg)
    return {k: torch.from_numpy(np.stack(v)).to(device) for k, v in out.items()}


def phase_train(device, batch=BATCH, height=HEIGHT, width=WIDTH, cfg=None,
                rois_per_image=TRAIN_ROIS, mask_rows=TRAIN_MASK_ROWS, card="", tag="7 train",
                params=None):
    """The training path through both kernels, with the mask branch (mask
    presets) or the keypoint branch (keypoint presets) over `mask_rows`
    fg-capacity rows; returns the launch counts of the three timed steps and
    the step rate."""
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
    if params is None:
        params = params_to_device(params_from_jax(init_params(cfg, seed=0)), device)
    # random weights on one fixed batch: at the schedule's LR (0.01) the
    # class loss swings over the first steps; 1e-4 makes it fall steadily
    solver = SolverConfig(base_lr=1e-4, warmup_iters=0)
    init_state, make_step = make_train_step(cfg, solver, train_mask=cfg.use_mask,
                                            roi_align_impl=roi_align_impl(cfg))
    state, opt = init_state(params)
    del params
    step = make_step(opt)
    fixed = make_train_batch(np.random.RandomState(0), batch, height, width, cfg.num_classes,
                             rois_per_image, mask_rows, device=device, **branch_rows(cfg))
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    fixed["image"] = torch.randn((batch, height, width, 3), generator=gen, device=device) * 50.0
    n_fg = int((fixed["labels"] > 0).sum())
    rows = "mask" if cfg.use_mask else "keypoint"
    log(f"[{tag}] {cfg.name} compute={cfg.compute_dtype} batch={batch} {height}x{width}, "
        f"{rois_per_image} rois ({n_fg} fg in all) and {mask_rows} {rows} rows per image: "
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
    log(f"[{tag}] warm-up step: {time.perf_counter() - t0:.3f} s")
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
        fixed["valid"], **branch_extras(fixed))
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
    log(f"[{tag}] steps: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms -> "
        f"{sum(times) / len(times) * 1e3:.1f} ms/step, {rate:.2f} img/s on {card or device}; "
        f"peak memory {peak:.2f} GiB; kernel launches in 3 steps {launches}")
    log(f"[{tag}] step 5 in stages: forward {stages[0] * 1e3:.1f} ms, backward "
        f"{stages[1] * 1e3:.1f} ms, optimizer {stages[2] * 1e3:.1f} ms")
    log(f"[{tag}] loss over 5 steps on one batch: {', '.join(f'{v:.4f}' for v in losses)}; "
        f"step 5 {', '.join(f'{k} {v:.4f}' for k, v in last.items())}")
    if device.type == "cuda":
        check(launches == {"roi_align_fwd": 6, "roi_align_bwd": 6},
              f"kernel launches {launches} in 3 steps, expected 2 forward + 2 backward each")
    check(losses[-1] < losses[0], f"loss did not fall over 5 steps: {losses}")
    if not cfg.use_fpn or cfg.keypoint is not None:
        size = branch_size(cfg)
        crowd = most_rois_on_a_tile(cfg, batch, height, width, fixed["rois"],
                                    [(rois_per_image, cfg.roi_size), (mask_rows, size)])
        log(f"[{tag}] most rois on one backward tile: {crowd[0]} (box, {cfg.roi_size}x"
            f"{cfg.roi_size}), {crowd[1]} ({rows} rows, {size}x{size})")
    return launches, rate


def branch_rows(cfg):
    """make_train_batch's mask_res and keypoints for cfg's second branch."""
    if cfg.keypoint is not None:
        return {"mask_res": 0, "keypoints": cfg.keypoint.num_keypoints}
    return {"mask_res": cfg.mask.resolution, "keypoints": 0}


def branch_size(cfg):
    """The RoIAlign size of cfg's second branch (mask or keypoint)."""
    return cfg.keypoint.roi_size if cfg.keypoint is not None else cfg.mask.roi_size


def branch_extras(batch):
    """The mask or keypoint blobs of a host-sampled batch, by their
    box_branch_loss names."""
    return {k: batch[k] for k in ("mask_targets", "mask_valid", "kp_labels", "kp_valid")
            if k in batch}


def roi_align_impl(cfg):
    """JAX's RoIAlign name for cfg's training: the Pallas names are the FPN
    path; C4 trains with 'gather'. Every name runs the port's kernels."""
    return "pallas-slab" if cfg.use_fpn else "gather"


def most_rois_on_a_tile(cfg, batch, height, width, rois, branches):
    """The longest per-tile roi list of the backward kernel for each
    (rows, pooled) branch over the first `rows` rois of each image."""
    import torch

    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_tile_lists
    from detectorch_tpu_torch.ops.fpn_levels import map_rois_to_fpn_levels

    if cfg.use_fpn:
        shapes = [(batch, height // s, width // s, cfg.fpn.channels) for s in (4, 8, 16, 32)]
        scales, sampling_ratio = cfg.fpn_spatial_scales, cfg.roi_sampling_ratio
    else:
        shapes = [(batch, height // 16, width // 16, 1024)]
        scales, sampling_ratio = (cfg.spatial_scale,), cfg.roi_sampling_ratio
    crowd = []
    for rows, pooled in branches:
        r = rois[:, :rows].reshape(-1, 4).float().contiguous()
        levels = ((map_rois_to_fpn_levels(r) - 2) if cfg.use_fpn
                  else torch.zeros(len(r), dtype=torch.int64, device=r.device))
        bidx = torch.arange(batch, dtype=torch.int32, device=r.device).repeat_interleave(rows)
        starts, _ = roi_tile_lists(shapes, r, bidx, levels.to(torch.int32), scales, pooled,
                                   pooled, sampling_ratio)
        crowd.append(int((starts[1:] - starts[:-1]).max()))
    return crowd


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


def fused_variants(cfg):
    """The differentiable RoIAlign of cfg's training through the kernels (K),
    through the kernel forward and the plain backward (KP), and through both
    plain versions (P)."""
    import functools

    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_c4, roi_align_fwd
    from detectorch_tpu_torch.ops.roi_align import (
        multilevel_roi_align,
        multilevel_roi_align_backward,
        roi_align_matmul,
        roi_align_matmul_backward,
    )
    from detectorch_tpu_torch.ops.roi_align_fused import roi_align_c4_fused, roi_align_fused

    if cfg.use_fpn:
        fused, kfwd, pfwd, pbwd = (roi_align_fused, roi_align_fwd, multilevel_roi_align,
                                   multilevel_roi_align_backward)
    else:
        fused, kfwd, pfwd, pbwd = (roi_align_c4_fused, roi_align_c4, roi_align_matmul,
                                   roi_align_matmul_backward)
    return (fused, functools.partial(fused, fwd=kfwd, bwd=pbwd),
            functools.partial(fused, fwd=pfwd, bwd=pbwd))


def phase_fp32_grads(device, height=HEIGHT, width=WIDTH, cfg=None, rois_per_image=TRAIN_ROIS,
                     mask_rows=TRAIN_MASK_ROWS, tag="8 fp32 grads", params=None):
    """One image of the fp32 training step: gradients through the kernels
    (K), through the kernel forward and the plain backward (KP), and through
    both plain versions (P)."""
    import numpy as np
    import torch

    from detectorch_tpu_torch.config import PRESETS, SolverConfig
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.models.detector import init_params
    from detectorch_tpu_torch.train.train_step import box_branch_loss, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (cfg or PRESETS[PRESET]).replace(compute_dtype="float32")
    if params is None:
        params = params_to_device(params_from_jax(init_params(cfg, seed=0)), device)
    b = make_train_batch(np.random.RandomState(5), 1, height, width, cfg.num_classes,
                         rois_per_image, mask_rows, device=device, **branch_rows(cfg))
    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    b["image"] = torch.randn((1, height, width, 3), generator=gen, device=device) * 50.0
    init_state, _ = make_train_step(cfg, SolverConfig(), train_mask=cfg.use_mask)

    def grads(roi_align):
        state, _ = init_state(params)
        total, _ = box_branch_loss(
            state.params, cfg, b["image"], b["rois"], b["labels"], b["bbox_targets"],
            b["bbox_inside_weights"], b["bbox_outside_weights"], b["valid"],
            roi_align=roi_align, **branch_extras(b))
        total.sum().backward()
        return float(total.detach().sum()), {k: v.grad for k, v in state.params.items()
                                    if v.grad is not None}

    k, kp, p = fused_variants(cfg)
    # cuDNN's deterministic algorithms: the keypoint head's transposed convs
    # run cuDNN's backward-data algorithms forward, some of which add with
    # atomics, and the comparison below holds the three runs to one forward
    # (on the card, one of three identical keypoint calls read 38.844124
    # with the default algorithms, the others 38.844120)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        loss_k, g_k = grads(k)
        loss_kp, g_kp = grads(kp)
        loss_p, g_p = grads(p)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(g_k.keys() == g_kp.keys() == g_p.keys(), "different leaves received gradients")

    rel_kp, _, cos_kp = compare_grads(g_k, g_kp)
    rel_p, rest_p, cos_p = compare_grads(g_k, g_p)
    log(f"[{tag}] 1 image, {len(g_k)} trainable leaves with gradients; loss "
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


def compare_results(a, b, tie=0.0):
    """tests/test_engine.py's comparison of two engines' COCO results: per
    image the same number of detections; in score order the same classes,
    boxes within rtol 1e-4 / atol 1e-3, and equal mask RLEs. With `tie` > 0,
    a detection of `a` may pair with any unpaired one of `b` of its image
    whose score lies within `tie` of its own (the same class and box, or
    RLE, first): near-tied scores may come out of the two engines in either
    order. Returns the counts of what differs, the largest box difference
    and the number of pairs that were not in the same place."""
    import numpy as np

    diff = {"images": 0, "classes": 0, "boxes": 0, "masks": 0}
    max_box, moved = 0.0, 0
    for key in ("bbox", "segm"):
        ra = sorted(a[key], key=lambda r: (r["image_id"], -r["score"]))
        rb = sorted(b[key], key=lambda r: (r["image_id"], -r["score"]))
        ids_a, ids_b = [r["image_id"] for r in ra], [r["image_id"] for r in rb]
        if ids_a != ids_b:
            diff["images"] += 1
            continue

        def same(x, y):
            if x["category_id"] != y["category_id"]:
                return False
            if key == "bbox":
                return np.allclose(x["bbox"], y["bbox"], rtol=1e-4, atol=1e-3)
            return x["segmentation"] == y["segmentation"]

        used = [False] * len(rb)
        for i, x in enumerate(ra):
            j = i
            if tie > 0 and (used[i] or not same(x, rb[i])):
                near = [k for k, y in enumerate(rb) if not used[k] and y["image_id"] ==
                        x["image_id"] and abs(y["score"] - x["score"]) <= tie]
                match = [k for k in near if same(x, rb[k])]
                j = (match or near or [i])[0]
                moved += j != i
            used[j] = True
            y = rb[j]
            diff["classes"] += x["category_id"] != y["category_id"]
            if key == "bbox":
                d = np.abs(np.subtract(x["bbox"], y["bbox"]))
                max_box = max(max_box, float(d.max()))
                diff["boxes"] += not np.allclose(x["bbox"], y["bbox"], rtol=1e-4, atol=1e-3)
            else:
                diff["masks"] += x["segmentation"] != y["segmentation"]
    return diff, max_box, moved


def paste_inputs(cfg, test_cfg, params, pictures, batch, device):
    """One batch of `pictures` (RGB images of one size) through the batched
    engine: each image's valid detections' masks and boxes, and its size, as
    finalize_batch hands them to the paste."""
    from detectorch_tpu_torch.eval.engine import BatchedInferenceEngine

    engine = BatchedInferenceEngine(cfg, test_cfg, params, batch, device=device)
    samples = [engine.preprocess(im) for im in pictures]
    pk, masks, _ = engine.submit_batch(samples)
    pk, masks = pk.cpu().numpy(), masks.cpu().float().numpy()
    out = []
    for i, (_, oh, ow) in enumerate(samples):
        valid = pk[i, :, 6] > 0.5
        out.append((masks[i][valid], pk[i, :, :4][valid], int(oh), int(ow)))
    return out


def phase_eval(device, images=EVAL_IMAGES, batch=BATCH, cfg=None, test_cfg=None,
               parity_images=PARITY_IMAGES, card="", tag="9 eval", weights=None, tie=0.0,
               keep=None):
    """COCO evaluation through the port's entry points; returns the forward
    kernel's launch count in the timed run and its img/s. A `keep` dict
    receives what phase 26 reuses: the dataset, the segm results, the
    finalize seconds, and the paste inputs of one batch of each orientation
    (its first half: 4 images at 480x640 and 4 at 640x480)."""
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
        c2.save_caffe2_pkl(params_from_jax(weights or init_params(cfg, seed=0)), cfg, pkl)
        params = c2.fold_bn(c2.import_params(c2.load_caffe2_pkl(pkl), cfg))
        ds = CocoDataset(ann, root)
        roidb = ds.get_roidb(gt=False)
        shapes = {e.image_id: (e.height, e.width) for e in roidb}
        what = ", ".join(f"{c} at {h}x{w}" for h, w, c in images)
        log(f"[{tag}] {len(roidb)} images ({what}), {len(ds.coco.anns)} gt objects; "
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
        log(f"[{tag}] warm-up over {len(firsts)} short batches: {time.perf_counter() - t0:.2f} s")
        roi_align_fwd.launches = 0
        t0 = time.perf_counter()
        bbox_stats, segm_stats, info = run(roidb=roidb)
        launches = roi_align_fwd.launches
        wall = time.perf_counter() - t0
        engines.clear()
        if keep is not None:
            keep.update(dataset=ds, segm=info["segm"],
                        finalize_s=info["phase_seconds"]["finalize"], paste=[])
            for h, w, _ in images:
                pictures = [pics[os.path.basename(e.file_path)] for e in roidb
                            if (e.height, e.width) == (h, w)][:batch]
                keep["paste"] += paste_inputs(cfg, test_cfg, params, pictures, batch,
                                              device)[:batch // 2]
        n_batches = sum(math.ceil(c / batch) for _, _, c in images)
        per_image = collections.Counter(r["image_id"] for r in info["bbox"])
        split = " ".join(f"{k}={v:.3f}s" for k, v in info["phase_seconds"].items())
        log(f"[{tag}] {cfg.name} compute={cfg.compute_dtype} batch={batch}, device "
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
        log(f"[{tag}] detections per image {min(per_image.values())}-{max(per_image.values())}; "
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
        diff, max_box, moved = compare_results(single, batched, tie)
        counts = sorted(collections.Counter(r["image_id"] for r in single["bbox"]).items())
        log(f"[{tag}] fp32 parity, first {parity_images} images, batched (batch "
            f"{parity_images}) vs single-image engine: detections per image {counts}; "
            f"differences {diff}; max|d box| {max_box:.3g} (rtol 1e-4, atol 1e-3)"
            + (f"; {moved} pairs of scores within {tie:g} in the other order" if tie else ""))
        check(not any(diff.values()), f"batched and single-image results differ: {diff}")
    return launches, info["images_per_sec"]


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
                    post=TRAIN_POST, gt_range=(3, 20), card="", tag="10 e2e", params=None,
                    profiled=True):
    """The e2e Mask (or Keypoint) R-CNN step through both kernels, in the
    uint8 schema; returns the launch counts of the three timed steps and the
    step rate."""
    import numpy as np
    import torch

    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.config import PRESETS, SamplerConfig, SolverConfig
    from detectorch_tpu_torch.models.detector import init_params
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd, roi_align_fwd
    from detectorch_tpu_torch.tools.profile_e2e_train import make_e2e_batch
    from detectorch_tpu_torch.train.e2e import e2e_losses, make_e2e_train_step, torch_uniforms
    from detectorch_tpu_torch.train.solver import apply_update
    from detectorch_tpu_torch.train.train_step import device_images

    cfg = cfg or PRESETS[PRESET]
    batch = len(sizes)
    t0 = time.perf_counter()
    if params is None:
        params = params_to_device(params_from_jax(init_params(cfg, seed=0)), device)
    # random weights on one fixed batch: as in phase 7, 1e-4 makes the loss fall
    solver = SolverConfig(base_lr=1e-4, warmup_iters=0)
    sampler = SamplerConfig(rois_per_image=rois_per_image)
    kps = cfg.keypoint is not None
    init_state, make_step = make_e2e_train_step(
        cfg, solver, sampler, seed=0, train_pre_nms=pre, train_post_nms=post,
        train_mask=cfg.use_mask, train_keypoints=kps, device_input=True,
        blob_hw=(height, width), roi_align_impl=roi_align_impl(cfg))
    state, opt = init_state(params)
    del params
    step = make_step(opt)
    fixed = make_e2e_batch(np.random.RandomState(10), sizes, (height, width), target_size,
                           max_size, gt_range, device,
                           keypoints=cfg.keypoint.num_keypoints if kps else 0,
                           num_classes=cfg.num_classes)
    n_gt = fixed["gt_valid"].sum(dim=1).tolist()
    log(f"[{tag}] {cfg.name} compute={cfg.compute_dtype} batch={batch} in {height}x{width}, "
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
    log(f"[{tag}] warm-up step: {time.perf_counter() - t0:.3f} s")
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
        train_post_nms=post, extras=e2e_extras(cfg, fixed), stage=mark)
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
           "loss_kps" if kps else "loss_mask"} <= set(last), f"metrics {sorted(last)}")
    losses.append(last["loss"])

    # how the sampled rois crowd the backward kernel's tiles
    fg_rows = int(round(sampler.fg_fraction * rois_per_image))
    size = branch_size(cfg)
    crowd = most_rois_on_a_tile(cfg, batch, height, width, sampled.rois,
                                [(rois_per_image, cfg.roi_size), (fg_rows, size)])
    n_fg = (sampled.labels > 0).sum(dim=1).tolist()

    profile = profile_step(run, device) if device.type == "cuda" and profiled else None

    rate = batch * len(times) / sum(times)
    log(f"[{tag}] steps: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms -> "
        f"{sum(times) / len(times) * 1e3:.1f} ms/step, {rate:.2f} img/s on {card or device}; "
        f"peak memory {peak:.2f} GiB; kernel launches in 3 steps {launches}")
    log(f"[{tag}] step 5 in stages (ms): "
        + ", ".join(f"{name} {ms:.1f}" for name, ms in stages)
        + f"; total {sum(ms for _, ms in stages):.1f}")
    log(f"[{tag}] step 5 sample: fg rois per image {n_fg}, valid rois per image "
        f"{sampled.valid.sum(dim=1).tolist()}; most rois on one backward tile: {crowd[0]} (box, "
        f"{cfg.roi_size}x{cfg.roi_size}), {crowd[1]} ({'keypoint' if kps else 'mask'} rows, "
        f"{size}x{size})")
    log(f"[{tag}] loss over 5 steps on one batch: {', '.join(f'{v:.4f}' for v in losses)}; "
        f"step 5 {', '.join(f'{k} {v:.4f}' for k, v in last.items())}")
    if profile:
        log(f"[{tag}] step 6 under torch.profiler: {profile['wall_ms']:.1f} ms, device busy "
            f"{profile['busy_ms']:.1f} ms, idle share {profile['idle_share']:.3f}; "
            f"{profile['syncs']} cudaStreamSynchronize calls; most device time: "
            + ", ".join(f"{name} {ms:.2f} ms" for name, ms in profile["top"]))
    if device.type == "cuda":
        check(launches == {"roi_align_fwd": 6, "roi_align_bwd": 6},
              f"kernel launches {launches} in 3 steps, expected 2 forward + 2 backward each")
    check(losses[-1] < losses[0], f"loss did not fall over 5 steps: {losses}")
    return launches, rate


def e2e_extras(cfg, batch):
    """The e2e step's extras: the gt masks (mask presets) or the gt
    keypoints (keypoint presets) of a make_e2e_batch batch."""
    if cfg.keypoint is not None:
        return {"gt_keypoints": batch["gt_keypoints"]}
    return {"gt_masks": batch["gt_masks"], "gt_mask_valid": batch["gt_mask_valid"]}


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
    from detectorch_tpu_torch.tools.profile_e2e_train import make_e2e_batch
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


# --- the C4 family: e2e_mask_rcnn_R-50-C4_2x -------------------------------

C4_PRESET = "e2e_mask_rcnn_R-50-C4_2x"
R101_PRESET = "e2e_mask_rcnn_R-101-FPN_2x"
C4_SCALE = 1.0 / 16
C4_FWD_REL = 1e-5  # kernel vs the plain separable form: 1e-5 of max|plain|


def c4_weights(cfg, seed=0):
    """init_params with the stem's frozen BN scale (res_conv1_bn_s) times
    0.01. The random C4 trunk has no FPN neck to bound it and reaches ~1e3
    on images (res5 features ~8e2, RPN deltas ~16), where every softmax
    saturates on one class (so score_thresh 0 leaves fewer than 100
    detections) and one SGD step at the clip's bound moves the logits by
    ~1e2; at 0.01 the c4 map is ~10, the magnitude a trained model gives.
    JAX-layout numpy, as init_params gives."""
    from detectorch_tpu_torch.models.detector import init_params

    p = init_params(cfg, seed=seed)
    p["res_conv1_bn_s"] = p["res_conv1_bn_s"] * 0.01
    return p


def c4_work(rois, pooled, channels, height, width, sampling_ratio=0, max_grid=8):
    """The least operations of a C4 RoIAlign call over (B, N, 4) rois, as
    the separable form needs them on this run's rois: per roi, each of its
    distinct feature rows interpolated along x for every bin column
    (sum_pw nx(pw) * rows), then every bin summed over its rows (PW *
    sum_ph ny(ph)), an FMA per channel each; nx and ny are the columns and
    rows whose weight is not zero (ops/roi_align.separable_weights)."""
    from detectorch_tpu_torch.ops.roi_align import separable_weights

    ky, kx = separable_weights(rois.reshape(-1, 4).float(), C4_SCALE, pooled, pooled,
                               sampling_ratio, max_grid, height, width)
    ny = (ky != 0).sum(dim=2).double()           # (R, PH)
    nx = (kx != 0).sum(dim=2).double()           # (R, PW)
    rows = (ky != 0).any(dim=1).sum(dim=1).double()
    per_roi = nx.sum(dim=1) * rows + pooled * ny.sum(dim=1)
    return 2.0 * channels * float(per_roi.sum())


def c4_fwd_bound(feats, rois, pooled):
    """The C4 forward's least time: the feature map read once (counted from
    shapes), rois read, the fp32 output written, or its operations."""
    from detectorch_tpu_torch.tools.measure import roofline

    b, h, w, c = feats.shape
    r = rois.shape[0] * rois.shape[1]
    nbytes = feats.numel() * feats.element_size() + 16 * r + r * pooled * pooled * c * 4
    return roofline(nbytes, c4_work(rois, pooled, c, h, w))


def c4_bwd_bound(shape, rois, pooled, out_dtype):
    """The C4 backward's least time: g and rois read once, the gradient map
    written once, or its operations."""
    import torch

    from detectorch_tpu_torch.tools.measure import roofline

    b, h, w, c = shape
    r = rois.shape[0] * rois.shape[1]
    out = b * h * w * c * torch.empty((), dtype=out_dtype).element_size()
    return roofline(r * pooled * pooled * c * 4 + 16 * r + out, c4_work(rois, pooled, c, h, w))


def phase_c4_kernels(device, batch=BATCH, height=HEIGHT, width=WIDTH, channels=1024,
                     box_rois=BOX_ROIS, mask_rois=MASK_ROIS, train_rois=TRAIN_ROIS,
                     mask_rows=TRAIN_MASK_ROWS, timing=True):
    """Both kernels at the C4 call site's shapes (one level at 1/16, 1024
    channels, sampling_ratio 0 with max_grid 8, 14x14 bins) against the
    plain separable form on the card, whose time is that of JAX's own
    formulation (two cuBLAS matmuls per roi chunk, fp32); returns the
    forward's and the backward's call rows."""
    import torch

    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import (
        roi_align_c4,
        roi_align_c4_bwd,
        roi_tile_lists,
    )
    from detectorch_tpu_torch.ops.roi_align import roi_align_matmul, roi_align_matmul_backward

    fh, fw = height // 16, width // 16
    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    gen_clustered = torch.Generator(device=device)
    gen_clustered.manual_seed(13)
    fwd_calls, bwd_calls = [], []
    max_fwd, max_bwd = 0.0, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        feats = torch.randn((batch, fh, fw, channels), generator=gen, device=device).to(dtype)
        for n in (box_rois, mask_rois):
            for kind, make, g in (("random", make_rois, gen),
                                  ("clustered", make_clustered_rois, gen_clustered)):
                rois = make(g, batch, n, height, width, device)
                args = (feats, rois, 14, 14, C4_SCALE, 0)
                got = roi_align_c4(*args)
                ref = roi_align_matmul(*args, roi_chunk=64)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                scale = ref.abs().max().item()
                err = (got - ref).abs().max().item()
                max_fwd = max(max_fwd, err)
                msg = (f"[12 c4 kernels] fwd {str(dtype)[6:]:8s} {kind:9s} 14x14 x {batch}x{n} "
                       f"rois: max|kernel - plain| = {err:.3g} = {err / scale:.3g} of "
                       f"max|plain| {scale:.3g} (tol {C4_FWD_REL:g})")
                del got, ref
                if timing:
                    ms = cuda_time_ms(lambda: roi_align_c4(*args), iters=10)
                    plain_ms = cuda_time_ms(lambda: roi_align_matmul(*args, roi_chunk=64),
                                            iters=2, warmup=1)
                    bound_ms, bound_by = c4_fwd_bound(feats, rois, 14)
                    r = batch * n
                    msg += (f"; kernel {ms:.4f} ms ({ms * 1e3 / r:.4f} us/roi), separable "
                            f"two-matmul form (cuBLAS, fp32) {plain_ms:.4f} ms; bound "
                            f"{bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f}")
                    fwd_calls.append({"call": f"C4 {kind} {str(dtype)[6:]} 14x14 {r} rois",
                                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                      "bound_by": bound_by})
                log(msg)
                check(err <= C4_FWD_REL * scale, f"C4 forward kernel disagrees: {err}")
        del feats
    shape = (batch, fh, fw, channels)
    for n, rows_kind in ((train_rois, "box"), (mask_rows, "mask")):
        for kind, make in (("random", make_rois), ("clustered", make_clustered_rois)):
            rois = make(gen, batch, n, height, width, device)
            g = torch.randn((batch, n, 14, 14, channels), generator=gen, device=device)
            args = (g, shape, rois, 14, 14, C4_SCALE, 0)
            ref = roi_align_matmul_backward(*args, roi_chunk=64)
            got = roi_align_c4_bwd(*args)
            again = roi_align_c4_bwd(*args)
            got_bf16 = roi_align_c4_bwd(*args, out_dtype=torch.bfloat16)
            scale = ref.abs().max().item()
            err = (got - ref).abs().max().item()
            same = torch.equal(got, again)
            rounded = got_bf16.dtype == torch.bfloat16 and torch.equal(got_bf16,
                                                                      got.to(torch.bfloat16))
            max_bwd = max(max_bwd, err)
            flat = rois.reshape(-1, 4).contiguous()
            bidx = torch.arange(batch, dtype=torch.int32, device=device).repeat_interleave(n)
            starts, _ = roi_tile_lists([shape], flat, bidx, torch.zeros_like(bidx), (C4_SCALE,),
                                       14, 14, 0)
            longest = int((starts[1:] - starts[:-1]).max())
            msg = (f"[12 c4 kernels] bwd {kind:9s} {rows_kind} 14x14 x {batch}x{n} rois: "
                   f"max|kernel - plain| = {err:.3g} = {err / scale:.3g} of max|plain| "
                   f"{scale:.3g} (tol {BWD_REL:g}); two launches equal: {same}; bf16 = fp32 "
                   f"rounded once: {rounded}; most rois on one tile {longest}")
            del ref, again, got_bf16
            if timing:
                for dtype in (torch.bfloat16, torch.float32):
                    ms = cuda_time_ms(lambda: roi_align_c4_bwd(*args, out_dtype=dtype), iters=10)
                    plain_ms = cuda_time_ms(lambda: roi_align_matmul_backward(
                        *args, roi_chunk=64, out_dtype=dtype), iters=2, warmup=1)
                    bound_ms, bound_by = c4_bwd_bound(shape, rois, 14, dtype)
                    r = batch * n
                    msg += (f"; {str(dtype)[6:]} kernel {ms:.4f} ms ({ms * 1e3 / r:.4f} "
                            f"us/roi), separable form {plain_ms:.4f} ms, bound {bound_ms:.4f} "
                            f"ms ({bound_by}), share {bound_ms / ms:.3f}")
                    bwd_calls.append({
                        "call": f"C4 {kind} {str(dtype)[6:]} out {rows_kind} 14x14 {r} rois",
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "most_rois_on_a_tile": longest})
            log(msg)
            check(err <= BWD_REL * scale, f"C4 backward kernel disagrees: {err}")
            check(same, "two launches of the C4 backward differ")
            check(rounded, "C4 bf16 gradient is not the fp32 gradient rounded once")
            del got, g
    return {"fwd_calls": fwd_calls, "bwd_calls": bwd_calls, "fwd_err": max_fwd,
            "bwd_err": max_bwd}


def tool_stages(device, params, cfg, batch, height, width, test_cfg, names):
    """One request of cfg through tools/profile_stages (CUDA events between
    stages; the staged outputs held bitwise to the fused request's), on
    phase 4's inputs, with adjacent stages merged under this script's
    `names`. Returns ([(name, ms)], the tool's result, the inputs)."""
    import torch

    from detectorch_tpu_torch.config import TestConfig
    from detectorch_tpu_torch.tools.profile_stages import profile

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    inputs = _batch(gen, batch, height, width, device)
    res = profile(params, cfg, test_cfg or TestConfig(), inputs, device, iters=1, echo=False)
    merged = []
    for name, ms, _ in res["stages"]:
        name = names.get(name, name)
        if merged and merged[-1][0] == name:
            merged[-1] = (name, merged[-1][1] + ms)
        else:
            merged.append((name, ms))
    return merged, res, inputs


def phase_c4_stages(device, params, cfg, batch=BATCH, height=HEIGHT, width=WIDTH,
                    test_cfg=None):
    """One C4 request split by stage: c4 body, RPN + proposal NMS, box
    RoIAlign, res5 box head + predictors, postprocess, mask branch."""
    names = {"backbone": "c4 body", "rpn + proposals": "rpn + proposal nms",
             "box head": "res5 box head", "mask roialign": "mask branch",
             "mask head": "mask branch"}
    return tool_stages(device, params, cfg, batch, height, width, test_cfg, names)[0]


def phase_c4(device, smi):
    """Phases 12-16, the C4 family (e2e_mask_rcnn_R-50-C4_2x, bf16, batch 8,
    832x1344, full width and depth) and R-101-FPN inference; returns the
    kernels' C4 rows and the launch counts of each C4 path's timed run."""
    import torch

    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.config import PRESETS

    cfg = PRESETS[C4_PRESET]
    kernels = phase_c4_kernels(device)

    def params():
        return params_to_device(params_from_jax(c4_weights(cfg)), device)

    launches = {}
    c4_params = params()
    infer, _, _ = phase_main_path(device, cfg=cfg, card=smi, tag="13 c4 main", params=c4_params)
    launches["c4_inference"] = {"roi_align_fwd": infer, "roi_align_bwd": 0}
    stages = phase_c4_stages(device, c4_params, cfg)
    log("[13 c4 main] request in stages (ms): "
        + ", ".join(f"{name} {ms:.1f}" for name, ms in stages)
        + f"; total {sum(ms for _, ms in stages):.1f}")
    phase_fp32_parity(device, c4_params, cfg=cfg, tag="13 c4 fp32", images=2)
    del c4_params
    r101, _, _ = phase_main_path(device, cfg=PRESETS[R101_PRESET], card=smi, requests=2,
                                 tag="13 r101 main")
    launches["r101_inference"] = {"roi_align_fwd": r101, "roi_align_bwd": 0}
    torch.cuda.empty_cache()
    # the res5 head of c4_weights scores every class near 1/81: scores of one
    # class tie within fp32 rounding, which batch and single engines order
    # either way
    evals, _ = phase_eval(device, cfg=cfg, card=smi, tag="14 c4 eval", weights=c4_weights(cfg),
                          tie=1e-5)
    launches["c4_eval"] = {"roi_align_fwd": evals, "roi_align_bwd": 0}
    torch.cuda.empty_cache()
    launches["c4_training"], _ = phase_train(device, cfg=cfg, card=smi, tag="15 c4 train",
                                             params=params())
    torch.cuda.empty_cache()
    launches["c4_e2e_training"], _ = phase_e2e_train(device, cfg=cfg, card=smi,
                                                     tag="15 c4 e2e", params=params(),
                                                     profiled=False)
    torch.cuda.empty_cache()
    phase_fp32_grads(device, cfg=cfg, tag="16 c4 fp32 grads", params=params())
    torch.cuda.empty_cache()
    return {"kernels": kernels, "launches": launches}


# --- Keypoint R-CNN: e2e_keypoint_rcnn_R-50-FPN_1x ------------------------

KP_PRESET = "e2e_keypoint_rcnn_R-50-FPN_1x"
# eval: person-keypoints images made by data/synth at a COCO size
KP_EVAL_IMAGES, KP_EVAL_HW = 24, (480, 640)


def phase_kp_stages(device, params, cfg, batch=BATCH, height=HEIGHT, width=WIDTH,
                    test_cfg=None):
    """One keypoint request split by stage: backbone + neck, RPN +
    proposals, box RoIAlign + fc6/fc7 + predictors, postprocess, keypoint
    RoIAlign, keypoint trunk + deconv + upsample, decode. Returns the stages
    and the keypoint call's RoIAlign inputs (the pyramid and the (B, K, 4)
    scaled detection boxes)."""
    names = {"box roialign": "box roialign + fc6/fc7", "box head": "box roialign + fc6/fc7"}
    stages, res, inputs = tool_stages(device, params, cfg, batch, height, width, test_cfg, names)
    scale = inputs[1]
    return stages, (res["feats"], res["outputs"].detections.boxes * scale[:, None, None])


def fwd_call_row(feats, rois, cfg, what, tag, timing=True):
    """The forward kernel on one call site's inputs, (B, N, 4) rois over the
    pyramid `feats`, against the plain gather form: error, times, bound."""
    import torch

    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_fwd
    from detectorch_tpu_torch.ops.fpn_levels import map_rois_to_fpn_levels
    from detectorch_tpu_torch.ops.roi_align import multilevel_roi_align

    bsz, n = rois.shape[:2]
    pooled = cfg.keypoint.roi_size
    flat = rois.reshape(-1, 4).float().contiguous()
    levels = (map_rois_to_fpn_levels(flat) - 2).to(torch.int32).contiguous()
    bidx = torch.arange(bsz, dtype=torch.int32, device=flat.device).repeat_interleave(n)
    args = ([f.contiguous() for f in feats], flat, bidx, levels, cfg.fpn_spatial_scales,
            pooled, pooled, cfg.roi_sampling_ratio)
    got = roi_align_fwd(*args)
    ref = multilevel_roi_align(*args)
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    row = {"call": f"{what} {str(feats[0].dtype)[6:]} {pooled}x{pooled} {bsz * n} rois",
           "max_abs_err": err, "max_rel_err": err / scale}
    msg = (f"[{tag}] fwd kernel at the {what}: {bsz}x{n} rois at {pooled}x{pooled}, "
           f"{str(feats[0].dtype)[6:]} pyramid: max|kernel - plain| = {err:.3g} = "
           f"{err / scale:.3g} of max|plain| {scale:.3g} (tol {C4_FWD_REL:g})")
    if timing:
        ms = cuda_time_ms(lambda: roi_align_fwd(*args), iters=20)
        plain_ms = cuda_time_ms(lambda: multilevel_roi_align(*args), iters=3, warmup=1)
        bound_ms, bound_by = fwd_bound(args[0], flat, bidx, levels, args[4], pooled)
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        msg += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
                f"({bound_by}), share {bound_ms / ms:.3f}")
    log(msg)
    # the model's features are far from phase 3's unit normals: hold the
    # kernel to the plain version relative to the output's scale, as the C4
    # call (fp32 sums of <= 16 taps in another order: an ulp or so)
    check(err <= C4_FWD_REL * scale, f"forward kernel disagrees at the {what}: {err}")
    return row


def bwd_call_row(shapes, rois, cfg, what, tag, timing=True):
    """The backward kernel on one call site's rois, (B, N, 4) over a
    pyramid of `shapes`, with a random fp32 g, against the plain backward:
    error (of max|plain|), bitwise repeat, times of the bf16 gradient (the
    training path's), bound."""
    import torch

    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd
    from detectorch_tpu_torch.ops.fpn_levels import map_rois_to_fpn_levels
    from detectorch_tpu_torch.ops.roi_align import multilevel_roi_align_backward

    bsz, n = rois.shape[:2]
    pooled = cfg.keypoint.roi_size
    flat = rois.reshape(-1, 4).float().contiguous()
    levels = (map_rois_to_fpn_levels(flat) - 2).to(torch.int32).contiguous()
    bidx = torch.arange(bsz, dtype=torch.int32, device=flat.device).repeat_interleave(n)
    gen = torch.Generator(device=flat.device)
    gen.manual_seed(17)
    g = torch.randn((bsz * n, pooled, pooled, shapes[0][-1]), generator=gen,
                    device=flat.device)
    args = (g, shapes, flat, bidx, levels, cfg.fpn_spatial_scales, pooled, pooled,
            cfg.roi_sampling_ratio)
    ref = multilevel_roi_align_backward(*args)
    got = roi_align_bwd(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, roi_align_bwd(*args)))
    scale = max(r.abs().max().item() for r in ref)
    err = max((a - r).abs().max().item() for a, r in zip(got, ref))
    row = {"call": f"{what} bf16 out {pooled}x{pooled} {bsz * n} rois", "max_abs_err": err,
           "max_rel_err": err / scale}
    msg = (f"[{tag}] bwd kernel at the {what}: {bsz}x{n} rows at {pooled}x{pooled}: "
           f"max|kernel - plain| = {err:.3g} = {err / scale:.3g} of max|plain| (tol "
           f"{BWD_REL:g}); two launches equal: {same}")
    if timing:
        dtype = torch.bfloat16
        ms = cuda_time_ms(lambda: roi_align_bwd(*args, out_dtype=dtype), iters=20)
        plain_ms = cuda_time_ms(lambda: multilevel_roi_align_backward(*args, out_dtype=dtype),
                                iters=3, warmup=1)
        bound_ms, bound_by = bwd_bound(shapes, flat, bidx, levels, args[5], pooled, dtype)
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        msg += (f"; bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), share {bound_ms / ms:.3f}")
    log(msg)
    check(err <= BWD_REL * scale, f"backward kernel disagrees at the {what}: {err}")
    check(same, f"two launches of the backward kernel differ at the {what}")
    return row


def compare_keypoint_results(a, b):
    """Two engines' COCO keypoint results of the same images: each result of
    `a` paired with the unpaired one of `b` of its image whose keypoints lie
    nearest (the order of near-tied scores may differ); per keypoint, x and
    y within 1e-3 px, or, where a near-tied heatmap argmax moved, within two
    bins (2/56 of the keypoints' extent, plus 1 px). Returns (pairs,
    keypoints, moved, max|d| of the others, unmatched results)."""
    import numpy as np

    by_image = {}
    for r in b:
        by_image.setdefault(r["image_id"], []).append(np.reshape(r["keypoints"], (-1, 3)))
    pairs = keypoints = moved = unmatched = 0
    max_err = 0.0
    for r in a:
        ka = np.reshape(r["keypoints"], (-1, 3))
        cands = by_image.get(r["image_id"], [])
        if not cands:
            unmatched += 1
            continue
        d = [np.abs(c - ka)[:, :2].max(axis=1) for c in cands]
        j = int(np.argmin([x.sum() for x in d]))
        extent = np.ptp(ka[:, :2], axis=0).max() + 1.0
        far = d[j] > 1e-3
        if (d[j] > 2 * extent / 56 + 1e-3).any():
            unmatched += 1
            continue
        cands.pop(j)
        pairs += 1
        keypoints += len(ka)
        moved += int(far.sum())
        if (~far).any():
            max_err = max(max_err, float(d[j][~far].max()))
    return pairs, keypoints, moved, max_err, unmatched


def phase_kp_eval(device, cfg, card="", images=KP_EVAL_IMAGES, hw=KP_EVAL_HW, batch=BATCH,
                  parity_images=PARITY_IMAGES, tag="18 kp eval", test_cfg=None):
    """COCO keypoint evaluation of a person-keypoints set made by the port's
    data/synth copy (PNG files, read by evaluate_dataset's own loader),
    batched with on-device preprocessing; then the batched engine against
    the single-image engine in fp32. Returns the forward kernel's launches
    in the timed run."""
    import collections
    import functools
    import math
    import tempfile

    import numpy as np
    import torch

    from detectorch_tpu_torch.checkpoint.convert import params_from_jax
    from detectorch_tpu_torch.config import TestConfig
    from detectorch_tpu_torch.data.coco import CocoDataset
    from detectorch_tpu_torch.data.synth import build_synth_coco
    from detectorch_tpu_torch.eval.engine import evaluate_dataset
    from detectorch_tpu_torch.models.detector import init_params
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_fwd

    # random weights score the person class near 1/2: score_thresh 0 keeps
    # every detection slot
    test_cfg = test_cfg or TestConfig(score_thresh=0.0, device_preprocess=True)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ann, imdir = build_synth_coco(root, n_images=images, height=hw[0], width=hw[1], seed=0,
                                      with_keypoints=True)
        ds = CocoDataset(ann, imdir)
        roidb = ds.get_roidb(gt=False)
        params = params_from_jax(init_params(cfg, seed=0))
        n_kp = sum(a.get("num_keypoints", 0) > 0 for a in ds.coco.anns.values())
        log(f"[{tag}] {len(roidb)} person-keypoints images at {hw[0]}x{hw[1]} from data/synth, "
            f"{len(ds.coco.anns)} gt persons ({n_kp} with keypoints); set-up "
            f"{time.perf_counter() - t0:.2f} s")
        engines = {}
        run = functools.partial(evaluate_dataset, cfg, test_cfg, params, ds, verbose=False,
                                batch_size=batch, engines=engines, device=device)
        t0 = time.perf_counter()
        run(roidb=roidb[:1])
        log(f"[{tag}] warm-up (one short batch): {time.perf_counter() - t0:.2f} s")
        roi_align_fwd.launches = 0
        t0 = time.perf_counter()
        bbox_stats, _, info = run(roidb=roidb)
        launches = roi_align_fwd.launches
        wall = time.perf_counter() - t0
        engines.clear()
        n_batches = math.ceil(len(roidb) / batch)
        per_image = collections.Counter(r["image_id"] for r in info["keypoints"])
        kstats = info["keypoints_stats"]
        split = " ".join(f"{k}={v:.3f}s" for k, v in info["phase_seconds"].items())
        log(f"[{tag}] {cfg.name} compute={cfg.compute_dtype} batch={batch}, device "
            f"preprocess: {info['images_per_sec']:.2f} img/s end to end on {card or device} "
            f"(loop split: {split}); evaluate_dataset {wall:.2f} s with COCOeval; kernel "
            f"launches {launches} in {n_batches} batches")
        check(sorted(per_image) == sorted(e.image_id for e in roidb),
              f"an image has no keypoint result: {per_image}")
        check(len(info["keypoints"]) == len(info["bbox"]), "keypoints and boxes differ in number")
        check(all(len(r["keypoints"]) == 3 * cfg.keypoint.num_keypoints
                  and np.isfinite(r["keypoints"]).all() for r in info["keypoints"]),
              "a keypoint result is not 17 finite [x, y, v]")
        check(kstats is not None and len(kstats) == 10 and bool(np.isfinite(kstats).all()),
              f"COCOeval keypoint stats are not 10 finite numbers: {kstats}")
        check(bbox_stats is not None and len(bbox_stats) == 12, "no bbox stats")
        log(f"[{tag}] keypoint results per image {min(per_image.values())}-"
            f"{max(per_image.values())}; OKS stats (random weights: they show the path runs) "
            + " ".join(f"{v:.4f}" for v in kstats) + f"; bbox AP {bbox_stats[0]:.4f}")
        if device.type == "cuda":
            check(launches == 2 * n_batches,
                  f"RoIAlign kernel launched {launches} times in {n_batches} batches, "
                  "expected 2 each")

        # fp32, TF32 off: the batched engine's results equal the single-image
        # engine's. Random weights score the person class near 1/2, so scores
        # tie within fp32 rounding and the engines may list them in either
        # order: boxes pair within 1e-5 of score, keypoints by position
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        run32 = functools.partial(evaluate_dataset, cfg.replace(compute_dtype="float32"),
                                  test_cfg, params, ds, roidb=roidb[:parity_images],
                                  verbose=False, engines={}, device=device)
        _, _, single = run32(batch_size=1)
        _, _, batched = run32(batch_size=parity_images)
        diff, max_box, swapped = compare_results(single, batched, tie=1e-5)
        pairs, kps, moved, kp_err, unmatched = compare_keypoint_results(single["keypoints"],
                                                                        batched["keypoints"])
        log(f"[{tag}] fp32 parity, first {parity_images} images, batched (batch "
            f"{parity_images}) vs single-image engine: {len(single['bbox'])} detections; box "
            f"differences {diff}, max|d box| {max_box:.3g}, {swapped} near-tied pairs in the "
            f"other order; keypoints: {pairs} results paired, {unmatched} unmatched; {moved} of "
            f"{kps} keypoints on a near-tied bin, the rest within {kp_err:.3g} px (tol 1e-3)")
        check(not any(diff.values()), f"batched and single-image boxes differ: {diff}")
        check(unmatched == 0 and pairs == len(batched["keypoints"]),
              f"keypoint results do not pair: {unmatched} unmatched")
        check(moved <= 0.01 * kps, f"{moved} of {kps} keypoints moved a bin")
    return launches


def phase_kp(device, smi):
    """Phases 17-21, Keypoint R-CNN (e2e_keypoint_rcnn_R-50-FPN_1x, bf16,
    batch 8, 832x1344, full width and depth: 8 convs of 512, 17 keypoints,
    56x56 heatmaps, init_params(seed 0)); returns the launch counts of each
    path's timed run and the kernel rows at the keypoint call sites."""
    import numpy as np
    import torch

    from detectorch_tpu_torch.config import PRESETS

    cfg = PRESETS[KP_PRESET]
    launches, calls = {}, {"fwd": [], "bwd": []}
    infer, _, params = phase_main_path(device, cfg=cfg, card=smi, tag="17 kp main")
    launches["keypoint_inference"] = {"roi_align_fwd": infer, "roi_align_bwd": 0}
    stages, (feats, kp_rois) = phase_kp_stages(device, params, cfg)
    log("[17 kp main] request in stages (ms): "
        + ", ".join(f"{name} {ms:.1f}" for name, ms in stages)
        + f"; total {sum(ms for _, ms in stages):.1f}")
    calls["fwd"].append(fwd_call_row(feats, kp_rois, cfg, "keypoint call", "17 kp main",
                                     timing=device.type == "cuda"))
    shapes = [tuple(f.shape) for f in feats]
    del feats, kp_rois
    phase_fp32_parity(device, params, cfg=cfg, tag="17 kp fp32", images=2)
    del params
    torch.cuda.empty_cache()
    launches["keypoint_eval"] = {"roi_align_fwd": phase_kp_eval(device, cfg, card=smi),
                                 "roi_align_bwd": 0}
    torch.cuda.empty_cache()
    launches["keypoint_training"], _ = phase_train(device, cfg=cfg, card=smi, tag="19 kp train")
    rows = make_train_batch(np.random.RandomState(0), BATCH, HEIGHT, WIDTH, cfg.num_classes,
                            TRAIN_ROIS, TRAIN_MASK_ROWS, device=device, **branch_rows(cfg))["rois"]
    calls["bwd"].append(bwd_call_row(shapes, rows[:, :TRAIN_MASK_ROWS], cfg,
                                     "keypoint training call", "19 kp train",
                                     timing=device.type == "cuda"))
    torch.cuda.empty_cache()
    launches["keypoint_e2e_training"], _ = phase_e2e_train(device, cfg=cfg, card=smi,
                                                           tag="20 kp e2e", profiled=False)
    torch.cuda.empty_cache()
    phase_fp32_grads(device, cfg=cfg, tag="21 kp fp32 grads")
    torch.cuda.empty_cache()
    return {"launches": launches, "calls": calls}


# ------------------------------------------------- parallel (phases 22-25)

# world 2 against world 1: losses and metrics (JAX's sharded tests' rtol)
PAR_LOSS_RTOL = 2e-4
# the e2e phases' per-rank images of the global batch 8, and the batch of
# the fp32 params check
PAR_BATCH, PAR_PARAMS_BATCH = 8, 2
PAR_INFER_IMAGES = 2


def e2e_setup(device, dtype, sizes=E2E_SIZES, height=HEIGHT, width=WIDTH, target_size=800,
              max_size=1333, rois_per_image=TRAIN_ROIS, gt_range=(3, 20)):
    """Phase 10's e2e Mask R-CNN inputs: its config in `dtype`, solver and
    sampler, and its uint8 batch (RandomState(10)) on `device`."""
    import numpy as np

    from detectorch_tpu_torch.config import PRESETS, SamplerConfig, SolverConfig
    from detectorch_tpu_torch.tools.profile_e2e_train import make_e2e_batch

    cfg = PRESETS[PRESET].replace(compute_dtype=dtype)
    batch = make_e2e_batch(np.random.RandomState(10), sizes, (height, width), target_size,
                           max_size, gt_range, device)
    return (cfg, SolverConfig(base_lr=1e-4, warmup_iters=0),
            SamplerConfig(rois_per_image=rois_per_image), batch)


def e2e_step_of(cfg, solver, sampler, hw, counts, mesh=None):
    """Phase 10's make_e2e_train_step (uint8 input, masks), on `mesh`."""
    from detectorch_tpu_torch.train.e2e import make_e2e_train_step

    return make_e2e_train_step(cfg, solver, sampler, seed=0, train_pre_nms=counts[0],
                               train_post_nms=counts[1], train_mask=True, device_input=True,
                               blob_hw=hw, roi_align_impl=roi_align_impl(cfg), mesh=mesh)


def e2e_rows_sample(params, cfg, sampler, rows, first, total, hw, counts, mesh=None):
    """The e2e losses of `rows` (images first.. of a global batch of
    `total`, drawing their uniforms as the step does), without a gradient:
    per-image metrics and the sampled rois, on the host."""
    import torch

    from detectorch_tpu_torch.train.e2e import e2e_losses, rank_uniforms
    from detectorch_tpu_torch.train.train_step import device_images

    draw = rank_uniforms(None, 0)
    n, dev = rows["raw"].shape[0], rows["raw"].device
    with torch.no_grad():
        _, metrics, sampled = e2e_losses(
            params, cfg, sampler, device_images(rows, hw), rows["gt_boxes"],
            rows["gt_classes"], rows["gt_valid"], rows["meta"][:, 2:5],
            lambda na, nc: draw(0, first, n, total, na, nc, dev), train_pre_nms=counts[0],
            train_post_nms=counts[1], extras=e2e_extras(cfg, rows), mesh=mesh)
    return ({k: v.float().cpu() for k, v in metrics.items()},
            {k: getattr(sampled, k).cpu() for k in ("rois", "labels", "valid", "gt_inds")})


def rows_of(batch, a, b):
    return {k: v[a:b] for k, v in batch.items()}


def momentum_by_name(state):
    """The SGD momentum of each trainable leaf, on the host."""
    names = [k for k, v in state.params.items() if v.requires_grad]
    return {names[i]: s["momentum_buffer"].cpu()
            for i, s in state.optimizer.state_dict()["state"].items()}


def phase_world1(device, card="", e2e_ms=None, backend="nccl", steps=4, **setup):
    """Phase 22: the e2e step through init_distributed_from_env and
    make_mesh on a one-rank group (torchrun's environment, `backend`),
    against the step without a mesh; the gradients' all-reduce alone, in
    flat buckets and leaf by leaf. Returns the phase's numbers."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.models.detector import init_params
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd, roi_align_fwd
    from detectorch_tpu_torch.parallel import mesh as par

    tag = "22 world 1"
    counts = setup.pop("counts", (TRAIN_PRE, TRAIN_POST))
    hw = (setup.get("height", HEIGHT), setup.get("width", WIDTH))
    cfg, solver, sampler, batch = e2e_setup(device, "bfloat16", **setup)
    host = params_from_jax(init_params(cfg, seed=0))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def run(mesh):
        """`steps` steps on the one batch: metrics of each, ms of all but
        the first, launches in those."""
        init_state, make_step = e2e_step_of(cfg, solver, sampler, hw, counts, mesh)
        state, opt = init_state(params_to_device(host, device))
        step, metrics, times = make_step(opt), [], []
        for i in range(steps):
            if i == 1:
                roi_align_fwd.launches = roi_align_bwd.launches = 0
            t0 = time.perf_counter()
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            sync()
            times.append(time.perf_counter() - t0)
        return {"metrics": metrics, "ms": sum(times[1:]) / (steps - 1) * 1e3,
                "launches": (roi_align_fwd.launches, roi_align_bwd.launches), "state": state}

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": str(device.index or 0)}
    saved_env = {k: os.environ.get(k) for k in env}
    deterministic = torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory() as tmp:
        os.environ.update(env)
        try:
            check(par.init_distributed_from_env(backend, "file://" + os.path.join(tmp, "rdzv")),
                  "init_distributed_from_env did not join the one-rank group")
            mesh = par.make_mesh(device=device)
            check(mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is not None
                  and dist.get_backend() == backend, f"mesh {mesh}, {dist.get_backend()}")
            # equality: cuDNN's deterministic algorithms make a step
            # reproducible, so the mesh's steps must give the plain steps'
            # metrics; times: the default algorithms, as phase 10
            torch.backends.cudnn.deterministic = True
            same = {name: run(m) for name, m in (("plain", None), ("mesh", mesh))}
            torch.backends.cudnn.deterministic = deterministic
            timed = {name: run(m) for name, m in (("plain", None), ("mesh", mesh))}
            worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                        for a, b in zip(same["mesh"]["metrics"], same["plain"]["metrics"])
                        for k in b if k.startswith("loss"))
            # the all-reduce alone, on gradients of the model's trainable leaves
            params = timed["mesh"]["state"].params
            trainable = [p for p in params.values() if p.requires_grad]
            for p in trainable:
                p.grad = torch.randn_like(p)
            n_train = sum(p.numel() for p in trainable)
            trainable_names = [k for k, p in params.items() if p.requires_grad]
            n_all = sum(p.numel() for p in params.values())

            def per_leaf():
                for p in trainable:
                    dist.all_reduce(p.grad)
                    p.grad.div_(torch.ones((), device=p.device))

            bucketed_ms = leaf_ms = 0.0  # a device time: none on the CPU
            if device.type == "cuda":
                bucketed_ms = cuda_time_ms(lambda: par.average_gradients(params, mesh), 10)
                leaf_ms = cuda_time_ms(per_leaf, 10)
            del params, trainable, same, timed["plain"]["state"], timed["mesh"]["state"]
        finally:
            torch.backends.cudnn.deterministic = deterministic
            if dist.is_initialized():
                dist.destroy_process_group()
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    plain, meshed = timed["plain"], timed["mesh"]
    log(f"[{tag}] {cfg.name} bf16 batch {len(batch['raw'])} through init_distributed_from_env + "
        f"make_mesh: {backend} group of 1, mesh {mesh.shape}; {n_all / 1e6:.2f}M parameters, "
        f"{n_train / 1e6:.2f}M trainable ({n_train * 4 / 2 ** 20:.1f} MiB of fp32 gradients)")
    log(f"[{tag}] metrics of {steps} steps, deterministic cuDNN, mesh vs no mesh: largest "
        f"relative loss difference {worst:.3g} (rtol {PAR_LOSS_RTOL:g})")
    log(f"[{tag}] {meshed['ms']:.1f} ms/step on the mesh, {plain['ms']:.1f} without (this run)"
        + (f", phase 10 {e2e_ms:.1f}" if e2e_ms else "") + f" on {card or device}; gradient "
        f"all-reduce: {bucketed_ms:.3f} ms bucketed, {leaf_ms:.3f} ms leaf by leaf "
        f"({len(trainable_names)} trainable leaves); launches in {steps - 1} steps "
        f"{meshed['launches']}")
    check(worst <= PAR_LOSS_RTOL, f"mesh metrics differ from the plain step's by {worst:.3g}")
    check(all(np.isfinite(v) for m in meshed["metrics"] for v in m.values()), "non-finite")
    if device.type == "cuda":
        check(meshed["launches"] == (2 * (steps - 1), 2 * (steps - 1)),
              f"kernel launches {meshed['launches']} in {steps - 1} steps on the mesh")
    return {"ms_per_step": meshed["ms"], "plain_ms_per_step": plain["ms"],
            "allreduce_bucketed_ms": bucketed_ms, "allreduce_per_leaf_ms": leaf_ms,
            "launches": {"roi_align_fwd": meshed["launches"][0],
                         "roi_align_bwd": meshed["launches"][1]}}


def parallel_references(device, ref_path, eval_root, setup, infer_hw, eval_images, eval_test):
    """World 1 for phases 23-24, fp32 with TF32 off, saved to `ref_path`:
    the e2e losses and sample of each rank's rows of the global batch 8
    (run as that rank's batch: cuDNN picks its algorithms by the batch),
    the momentum and params after one step at global batch 2 from the mean
    of its images' gradients, taken one image at a time, and the eval
    results of phase 9's images at batch 8."""
    import numpy as np
    import torch

    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.data.coco import CocoDataset
    from detectorch_tpu_torch.eval.engine import evaluate_dataset
    from detectorch_tpu_torch.models.detector import init_params
    from detectorch_tpu_torch.train.e2e import e2e_losses, rank_uniforms
    from detectorch_tpu_torch.train.solver import apply_update
    from detectorch_tpu_torch.train.train_step import device_images, make_init_state

    setup = dict(setup)
    counts = setup.pop("counts", (TRAIN_PRE, TRAIN_POST))
    hw = (setup.get("height", HEIGHT), setup.get("width", WIDTH))
    torch.backends.cudnn.allow_tf32 = False  # as the ranks run
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, solver, sampler, batch = e2e_setup(device, "float32", **setup)
    params = params_to_device(params_from_jax(init_params(cfg, seed=0)), device)
    state, opt = make_init_state(solver)(params)
    total = len(batch["raw"])
    half = total // 2
    ref = {"blocks": [], "metrics": []}
    for r in range(2):
        metrics, sampled = e2e_rows_sample(state.params, cfg, sampler,
                                           rows_of(batch, r * half, (r + 1) * half),
                                           r * half, total, hw, counts)
        ref["blocks"].append(sampled)
        ref["metrics"].append(metrics)
    ref["metrics"] = {k: float(torch.cat([m[k] for m in ref["metrics"]]).mean())
                      for k in ref["metrics"][0]}
    # one step at global batch 2 from the mean of the two images' gradients
    draw = rank_uniforms(None, 0)
    for i in range(PAR_PARAMS_BATCH):
        rows = rows_of(batch, i, i + 1)
        t, _, _ = e2e_losses(state.params, cfg, sampler, device_images(rows, hw),
                             rows["gt_boxes"], rows["gt_classes"], rows["gt_valid"],
                             rows["meta"][:, 2:5],
                             lambda na, nc: draw(0, i, 1, PAR_PARAMS_BATCH, na, nc, device),
                             train_pre_nms=counts[0], train_post_nms=counts[1],
                             extras=e2e_extras(cfg, rows))
        (t.mean() / PAR_PARAMS_BATCH).backward()
    apply_update(opt, 0, solver)
    ref["momentum"] = momentum_by_name(state)
    ref["params"] = {k: v.detach().cpu() for k, v in state.params.items()}
    del state, opt, params
    # inference: the images, made on the card from a seed as the ranks make them
    ref["infer"] = infer_inputs(device, infer_hw)
    # eval: world 1 in fp32 at batch 8, masks biased away from the threshold
    ann, pics = make_eval_set(eval_root, eval_images, np.random.RandomState(7))
    ecfg, etcfg, eparams = eval32_config(cfg.replace(compute_dtype="float32"), eval_test)
    _, _, info = evaluate_dataset(ecfg, etcfg, eparams, CocoDataset(ann, eval_root),
                                  verbose=False, batch_size=PAR_BATCH, engines={},
                                  load_image=lambda path: pics[os.path.basename(path)],
                                  device=device)
    ref["eval"] = {k: info[k] for k in ("bbox", "segm")}
    torch.save(ref, ref_path)
    if device.type == "cuda":
        torch.cuda.empty_cache()


def infer_inputs(device, hw):
    """Phase 24's inference batch: PAR_INFER_IMAGES noise blobs from a
    seeded generator, with their scale and original size."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(24)
    images = torch.randn((PAR_INFER_IMAGES, *hw, 3), generator=gen, device=device) * 50.0
    return [images.cpu()] + [torch.full((PAR_INFER_IMAGES,), v) for v in
                             (1.0, hw[0] * 0.96, hw[1] * 0.99)]


def eval_test_cfg(**overrides):
    """Phase 9's TestConfig: score_thresh 0 (random weights score every
    class near 1/81), on-device preprocessing."""
    from detectorch_tpu_torch.config import TestConfig

    return TestConfig(score_thresh=0.0, device_preprocess=True).replace(**overrides)


def eval32_config(cfg, eval_test):
    """Phase 9's fp32 parity setting: fp32 masks fetched, score_thresh 0,
    on-device preprocessing, init_params(seed 0) with a +-3 mask bias."""
    import numpy as np

    from detectorch_tpu_torch.checkpoint.convert import params_from_jax
    from detectorch_tpu_torch.models.detector import init_params

    params = init_params(cfg, seed=0)
    params["mask_fcn_logits_b"] = np.where(np.arange(cfg.num_classes) % 2, -3.0, 3.0
                                           ).astype(np.float32)
    return cfg, eval_test_cfg(mask_fetch_dtype="float32", **eval_test), params_from_jax(params)


def parallel_rank(ref_path, eval_root, setup, infer_hw, eval_images, eval_test):
    """Phases 23 and 24 on one of two ranks sharing a card over gloo (or on
    the CPU): returns this rank's numbers; a failed check raises."""
    import functools

    import numpy as np
    import torch

    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.config import PRESETS, TestConfig
    from detectorch_tpu_torch.data.coco import CocoDataset
    from detectorch_tpu_torch.eval.engine import evaluate_dataset
    from detectorch_tpu_torch.models.detector import init_params, make_inference_fn
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd, roi_align_fwd
    from detectorch_tpu_torch.parallel import mesh as par
    from detectorch_tpu_torch.parallel.dryrun import compare_outputs, to_host

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the CPU only where there is no card (a rehearsal of the phase)
    device = par.default_device() if torch.cuda.is_available() else torch.device("cpu")
    ref = torch.load(ref_path, map_location="cpu", weights_only=False)
    mesh = par.make_mesh(device=device)
    r, out = mesh.coords["data"], {"rank": mesh.rank, "device": str(device)}
    setup = dict(setup)
    counts = setup.pop("counts", (TRAIN_PRE, TRAIN_POST))
    hw = (setup.get("height", HEIGHT), setup.get("width", WIDTH))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # 23: the e2e step at global batch 8 (fp32): this rank's sample and the
    # global metrics against world 1
    cfg, solver, sampler, batch = e2e_setup(device, "float32", **setup)
    host = params_from_jax(init_params(cfg, seed=0))
    init_state, make_step = e2e_step_of(cfg, solver, sampler, hw, counts, mesh)
    state, opt = init_state(params_to_device(host, device))
    total = len(batch["raw"])
    half = total // 2
    rows = rows_of(batch, r * half, (r + 1) * half)
    _, sampled = e2e_rows_sample(state.params, cfg, sampler, rows, r * half, total, hw, counts,
                                 mesh)
    exp = ref["blocks"][r]
    for k in ("labels", "valid", "gt_inds"):
        got, want = sampled[k], exp[k]
        if k == "gt_inds":
            got, want = got[exp["valid"]], want[exp["valid"]]
        check(torch.equal(got, want), f"rank {r}: sampled {k} differ from world 1's")
    roi_err = float((sampled["rois"] - exp["rois"]).abs().max())
    check(roi_err <= 2e-3, f"rank {r}: sampled rois {roi_err} px from world 1's")
    roi_align_fwd.launches = roi_align_bwd.launches = 0
    t0 = time.perf_counter()
    state, metrics = make_step(opt)(state, rows)
    sync()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    out["step_launches"] = {"roi_align_fwd": roi_align_fwd.launches,
                            "roi_align_bwd": roi_align_bwd.launches}
    rel = {k: abs(float(metrics[k]) - v) / max(abs(v), 1e-12)
           for k, v in ref["metrics"].items()}
    out["loss_rel"] = max(rel.values())
    check(out["loss_rel"] <= PAR_LOSS_RTOL, f"rank {r}: metrics vs world 1 {rel}")
    out["sampled"] = {"rois_err": roi_err, "fg": int((sampled["labels"] > 0).sum())}
    del state, opt
    # one step at global batch 2: momentum and params against world 1's
    # mean of the images' gradients (a ReLU flip may move one channel)
    state, opt = init_state(params_to_device(host, device))
    state, _ = make_step(opt)(state, rows_of(batch, r, r + 1))
    if mesh.rank == 0:
        rel, rest, cos = compare_grads(momentum_by_name(state), ref["momentum"])
        p_err = max(float((v.detach().cpu() - ref["params"][k]).abs().max()
                          / max(ref["params"][k].abs().max(), 1e-30))
                    for k, v in state.params.items())
        out["params"] = {"momentum_rel": rel, "momentum_rest": rest, "cos": cos,
                         "params_rel": p_err}
        check(rel <= FLIP_REL and rest <= GRAD_REL and cos >= GRAD_COS,
              f"momentum after one step at global batch 2: {out['params']}")
    del state, opt, host

    # 24: inference over data 2 and over model 2 against this process
    # running the same rows with the whole params (fp32)
    icfg = PRESETS[PRESET].replace(compute_dtype="float32")
    itc = TestConfig(score_thresh=0.0)
    iparams = params_to_device(params_from_jax(init_params(icfg, seed=0)), device)
    images, *scalars = ref["infer"]
    out["inference"] = {}
    for shape in ((2, 1), (1, 2)):
        imesh = par.make_mesh(*shape, device=device)
        args = par.shard_batch(imesh, images, *scalars)
        roi_align_fwd.launches = 0
        got = par.make_batched_inference_fn(icfg, itc, imesh)(
            par.shard_params(iparams, imesh), *args)
        sync()
        launches = roi_align_fwd.launches
        single = make_inference_fn(icfg, itc)(iparams, *args)
        first = imesh.coords["data"] * len(args[0])
        errs = [compare_outputs(to_host(got), to_host(single), first + j, j)
                for j in range(len(args[0]))]
        out["inference"][f"{shape[0]}x{shape[1]}"] = {"launches": launches, "compare": errs}
        if device.type == "cuda":
            check(launches == 2, f"inference on mesh {shape}: {launches} forward launches")
    del iparams

    # 24: evaluate_dataset on the mesh: bf16 img/s, then fp32 results
    # against world 1's
    ann, pics = make_eval_set(_rank_dir(eval_root, mesh.rank), eval_images,
                              np.random.RandomState(7))
    ds = CocoDataset(ann, os.path.dirname(ann))
    roidb = ds.get_roidb(gt=False)
    load = functools.partial(_from_memory, pics)
    bcfg = PRESETS[PRESET]
    engines = {}
    run = functools.partial(evaluate_dataset, bcfg, eval_test_cfg(**eval_test),
                            params_from_jax(init_params(bcfg, seed=0)), ds, verbose=False,
                            batch_size=PAR_BATCH, mesh=mesh, engines=engines, load_image=load,
                            device=device)
    run(roidb=list({(e.height, e.width): e for e in reversed(roidb)}.values()))
    roi_align_fwd.launches = 0
    _, _, info = run(roidb=roidb)
    out["eval"] = {"images_per_sec": info["images_per_sec"],
                   "phase_seconds": info["phase_seconds"], "launches": roi_align_fwd.launches}
    engines.clear()
    ecfg, etcfg, eparams = eval32_config(icfg, eval_test)
    _, _, info = evaluate_dataset(ecfg, etcfg, eparams, ds, verbose=False, batch_size=PAR_BATCH,
                                  mesh=mesh, engines={}, load_image=load, device=device)
    diff, max_box, moved = compare_results(ref["eval"], info, tie=1e-5)
    out["eval32"] = {"diff": diff, "max_box": max_box, "moved": moved,
                     "detections": len(info["bbox"])}
    check(not any(diff.values()), f"rank {r}: eval results differ from world 1's: {diff}")
    return out


def _rank_dir(root, rank):
    path = os.path.join(root, f"rank{rank}")
    os.makedirs(path, exist_ok=True)
    return path


def _from_memory(pics, path):
    return pics[os.path.basename(path)]


def phase_parallel(device, card="", eval_rate=None, backend="gloo", setup=None,
                   infer_hw=(HEIGHT, WIDTH), eval_images=EVAL_IMAGES, eval_test=None):
    """Phases 23-24: two ranks on the one card over gloo (both on cuda:0;
    NCCL refuses two ranks on one device), against world 1 computed here
    first. Returns each rank's numbers."""
    import tempfile

    from detectorch_tpu_torch.parallel.launch import run_ranks

    setup, eval_test = setup or {}, eval_test or {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref_path = os.path.join(tmp, "world1.pt")
        parallel_references(device, ref_path, tmp, setup, infer_hw, eval_images, eval_test)
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = run_ranks(parallel_rank, 2, (ref_path, tmp, setup, infer_hw, eval_images,
                                            eval_test),
                          backend=backend, local_ranks=[device.index or 0] * 2, timeout_s=900)
        t_ranks = time.perf_counter() - t0
    for r in ranks:
        log(f"[23 world 2] rank {r['rank']} on {r['device']} (gloo): e2e step at global batch "
            f"{PAR_BATCH}, fp32: {r['step_ms']:.1f} ms, launches {r['step_launches']}; its "
            f"sample equals world 1's ({r['sampled']['fg']} fg rois, rois within "
            f"{r['sampled']['rois_err']:.3g} px), metrics within {r['loss_rel']:.3g} "
            f"(rtol {PAR_LOSS_RTOL:g})" + (f"; global batch {PAR_PARAMS_BATCH}, one step: "
                                           f"{r['params']}" if "params" in r else ""))
    for r in ranks:
        for shape, v in r["inference"].items():
            log(f"[24 inference] rank {r['rank']} mesh {shape}: {v['launches']} forward "
                f"launches; vs one process on its rows: {v['compare']}")
        split = " ".join(f"{k}={s:.3f}s" for k, s in r["eval"]["phase_seconds"].items())
        log(f"[24 eval] rank {r['rank']}: {r['eval']['images_per_sec']:.2f} img/s over "
            f"{sum(c for _, _, c in eval_images)} images at global batch {PAR_BATCH} "
            f"(loop split: {split}), {r['eval']['launches']} forward launches"
            + (f"; phase 9 (world 1) {eval_rate:.2f} img/s" if eval_rate else "")
            + " - two processes sharing one card, not a multi-card scaling figure")
        log(f"[24 eval] rank {r['rank']} fp32 results vs world 1: {r['eval32']}")
    log(f"[23-24] world 1 references {t_ref:.1f} s, two ranks {t_ranks:.1f} s")
    if device.type == "cuda":
        for r in ranks:
            check(r["step_launches"] == {"roi_align_fwd": 2, "roi_align_bwd": 2},
                  f"rank {r['rank']}: e2e step launches {r['step_launches']}")
            check(r["eval"]["launches"] > 0, f"rank {r['rank']}: no eval launch")
    return ranks


def phase_dryrun(device_type="cuda", **sizes):
    """Phase 25: dryrun_multichip(2) (data 1 x model 2) on the card."""
    from detectorch_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    results = dryrun_multichip(2, device_type, **sizes)
    for r in results:
        log(f"[25 dryrun] rank {r['rank']} mesh {r['mesh']} on {r['device']}: losses "
            f"{ {k: round(v, 4) for k, v in r['losses'].items()} }; sharded inference vs one "
            f"process: {r['compare']}; launches {r['launches']}")
        if device_type == "cuda":
            check(all(n > 0 for n in r["launches"]["train"]) and r["launches"]["inference"][0] > 0,
                  f"rank {r['rank']}: a kernel did not launch: {r['launches']}")
    log(f"[25 dryrun] dryrun_multichip(2) in {time.perf_counter() - t0:.1f} s")
    return results


# ---------------------------------------------------------------------------
# Phase 26: the demo, the native RLE, profiling and debug
# ---------------------------------------------------------------------------

# phase 9's `finalize` seconds on an H100 at 700 W before the native RLE,
# with the numpy paste encode (PERF.md §6)
FINALIZE_BEFORE = "0.58-1.24 s"
DEMO_THRESH = 0.5
KP_THRESH = 2.0  # utils/vis's kp_thresh: a keypoint logit above it is drawn
# the classes the demo's weights make confident: horse (mask bias +3, so its
# masks are drawn) above person; Keypoint R-CNN has person only
DEMO_CLASSES = {PRESET: {18: 7.0, 1: 6.0}, KP_PRESET: {1: 7.0}}


@contextlib.contextmanager
def numpy_rle():
    """The port's eval/rle with its numpy plain versions in place of the
    native library, for every caller that reaches them through the module's
    attributes (segm_results, COCOeval)."""
    from detectorch_tpu_torch.eval import rle

    names = ("counts_to_string", "string_to_counts", "encode_pasted", "area", "rle_iou")
    saved = {n: getattr(rle, n) for n in names}
    try:
        for n in names:
            setattr(rle, n, getattr(rle, f"{n}_np"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(rle, n, fn)


def phase_rle_native(kept, build_s, tag="26 rle"):
    """The native RLE against its numpy plain version on phase 9's data: the
    paste encode of 800 masks, COCOeval's segm IoU, and rle_iou over every
    detection-gt pair of each image. Returns its times."""
    import collections

    import numpy as np

    from detectorch_tpu_torch.eval import rle
    from detectorch_tpu_torch.eval.coco_eval import COCOeval
    from detectorch_tpu_torch.eval.mask_paste import segm_results

    m = next(masks.shape[-1] for masks, _, _, _ in kept["paste"])
    n_masks = sum(len(masks) for masks, _, _, _ in kept["paste"])
    sizes = sorted({(h, w) for _, _, h, w in kept["paste"]})

    def paste():
        t0 = time.perf_counter()
        out = [segm_results(masks, boxes, h, w, m) for masks, boxes, h, w in kept["paste"]]
        return out, (time.perf_counter() - t0) * 1e3

    # in turns: library, numpy, numpy, library
    native, ms_native = paste()
    with numpy_rle():
        plain, ms_plain = paste()
        _, ms_plain2 = paste()
    _, ms_native2 = paste()
    check(native == plain, "the native paste encode differs from the numpy version")
    check(sum(len(r) for r in native) == n_masks, "a mask was not encoded")

    def ious():
        coco = kept["dataset"].coco
        ev = COCOeval(coco, coco.load_res(kept["segm"]), "segm")
        t0 = time.perf_counter()
        ev.evaluate()
        return ev.ious, time.perf_counter() - t0

    # in turns, as the paste
    iou_native, s_native = ious()
    with numpy_rle():
        iou_plain, s_plain = ious()
        _, s_plain2 = ious()
    _, s_native2 = ious()
    pairs = sum(v.size for v in iou_native.values())
    check(iou_native.keys() == iou_plain.keys()
          and all(np.array_equal(iou_native[k], iou_plain[k]) for k in iou_native),
          "COCOeval's segm IoU differs with and without the native library")

    # COCOeval pairs a detection only with gts of its class: with random
    # weights that is few pairs, so time rle_iou over every pair of an image
    coco = kept["dataset"].coco
    per_image = collections.defaultdict(list)
    for r in kept["segm"]:
        per_image[r["image_id"]].append(r["segmentation"])
    cases = [(dts, [coco.ann_to_rle(a) for a in coco.load_anns_for_image(i)],
              [a.get("iscrowd", 0) for a in coco.load_anns_for_image(i)])
             for i, dts in sorted(per_image.items())]

    def all_pairs():
        t0 = time.perf_counter()
        out = [rle.rle_iou(*case) for case in cases]
        return out, (time.perf_counter() - t0) * 1e3

    dense, ms_dense = all_pairs()
    with numpy_rle():
        dense_plain, ms_dense_plain = all_pairs()
    check(all(np.array_equal(a, b) for a, b in zip(dense, dense_plain)),
          "rle_iou differs with and without the native library")
    log(f"[{tag}] native RLE built in {build_s:.2f} s (phase 2); paste + encode of {n_masks} "
        f"masks ({len(kept['paste'])} images, {' and '.join(f'{h}x{w}' for h, w in sizes)}; "
        f"phase 9's weights): library {ms_native:.1f} / {ms_native2:.1f} ms, numpy "
        f"{ms_plain:.1f} / {ms_plain2:.1f} ms, strings equal byte for byte; COCOeval segm "
        f"evaluate() over {len(kept['segm'])} results ({pairs} IoU pairs): library "
        f"{s_native:.3f} / {s_native2:.3f} s, numpy {s_plain:.3f} / {s_plain2:.3f} s, matrices "
        f"equal; rle_iou over every dt x gt "
        f"pair of each image ({sum(a.size for a in dense)} pairs): library {ms_dense:.1f} ms, "
        f"numpy {ms_dense_plain:.1f} ms, equal; phase 9's finalize "
        f"{kept['finalize_s']:.3f} s with the library (numpy, earlier runs: {FINALIZE_BEFORE})")
    return {"build_s": build_s, "masks": n_masks, "paste_encode_ms": [ms_native, ms_native2],
            "paste_encode_numpy_ms": [ms_plain, ms_plain2],
            "segm_evaluate_s": [s_native, s_native2], "segm_evaluate_numpy_s": [s_plain, s_plain2],
            "rle_iou_all_pairs_ms": ms_dense,
            "rle_iou_all_pairs_numpy_ms": ms_dense_plain,
            "phase9_finalize_s": kept["finalize_s"]}


def demo_pkl(cfg, path):
    """A Detectron pkl of init_params(seed 0) with confident classes
    (DEMO_CLASSES' cls_score biases: random scores sit near 1/81, under the
    demo's threshold), a +-3 mask_fcn_logits_b bias per class (random mask
    logits sit on the 0.5 threshold) and a +3 kps_score_lowres_b (keypoint
    logits above vis's kp_thresh), written as phase 9 writes its pkl."""
    from detectorch_tpu_torch.checkpoint import caffe2_import as c2
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax
    from detectorch_tpu_torch.models.detector import init_params

    params = init_params(cfg, seed=0)
    for c, b in DEMO_CLASSES[cfg.name].items():
        params["cls_score_b"][c] = b
    if cfg.use_mask:
        params["mask_fcn_logits_b"][0::2], params["mask_fcn_logits_b"][1::2] = 3.0, -3.0
    if cfg.keypoint is not None:
        params["kps_score_lowres_b"][:] = 3.0
    c2.save_caffe2_pkl(params_from_jax(params), cfg, path)


def demo_path(device, root, preset, tag):
    """tools/demo.main on a 480x640 PNG of the port's data/synth (its
    launches counted), then InferenceEngine.run_image on the same image and
    weights, warm: 2 forward launches and no backward launch a request (plus
    2 for each NMS-prefilter rerun), the file equal pixel for pixel to
    vis_one_image of run_image's result, something drawn. Returns the
    launches, the warm request's ms, and the engine and image for the
    profiling and debug checks."""
    import cv2
    import numpy as np
    import torch

    from detectorch_tpu_torch.checkpoint import caffe2_import as c2
    from detectorch_tpu_torch.config import PRESETS, TestConfig
    from detectorch_tpu_torch.data.synth import build_synth_coco
    from detectorch_tpu_torch.data.transforms import load_image_rgb
    from detectorch_tpu_torch.eval import rle
    from detectorch_tpu_torch.eval.engine import InferenceEngine
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd, roi_align_fwd
    from detectorch_tpu_torch.tools import demo
    from detectorch_tpu_torch.utils.vis import vis_one_image

    cfg = PRESETS[preset]
    keypoints = cfg.keypoint is not None
    t0 = time.perf_counter()
    ann, imdir = build_synth_coco(os.path.join(root, preset), n_images=1, height=480, width=640,
                                  seed=3, with_keypoints=keypoints)
    with open(ann) as f:
        image = os.path.join(imdir, json.load(f)["images"][0]["file_name"])
    pkl = os.path.join(root, f"{preset}.pkl")
    demo_pkl(cfg, pkl)
    out = os.path.join(root, f"{preset}.png")
    argv = ["--image", image, "--preset", preset, "--weights", pkl, "--out", out,
            "--thresh", str(DEMO_THRESH), "--device", str(device)]
    log(f"[{tag}] {preset}: data/synth image and Detectron pkl in "
        f"{time.perf_counter() - t0:.2f} s; python -m detectorch_tpu_torch.tools.demo "
        + " ".join(os.path.relpath(a, root) if a.startswith(root) else a for a in argv))
    roi_align_fwd.launches = roi_align_bwd.launches = 0
    t0 = time.perf_counter()
    res_cli = demo.main(argv)
    cli_s = time.perf_counter() - t0
    launches = {"roi_align_fwd": roi_align_fwd.launches, "roi_align_bwd": roi_align_bwd.launches}

    engine = InferenceEngine(cfg, TestConfig(), c2.fold_bn(c2.import_params(
        c2.load_caffe2_pkl(pkl), cfg)), device)
    im = load_image_rgb(image)
    roi_align_fwd.launches = 0
    t0 = time.perf_counter()
    res = engine.run_image(im)  # ends in host results: nothing left on the card
    request_ms = (time.perf_counter() - t0) * 1e3
    engine_launches = roi_align_fwd.launches
    reruns = max(launches["roi_align_fwd"] - 2, 0) // 2
    drawn = vis_one_image(im, res["boxes"], res["scores"], res["classes"], res.get("rles"),
                          res.get("keypoints"), thresh=DEMO_THRESH)
    written = cv2.imread(out)
    shown = res["scores"] >= DEMO_THRESH
    masks_drawn = sum(rle.area(res["rles"][i]) > 0 for i in np.flatnonzero(shown)) \
        if "rles" in res else 0
    kps_drawn = int((res["keypoints"][shown][..., 2] > KP_THRESH).sum()) if keypoints else 0
    log(f"[{tag}] demo.main: {cli_s:.2f} s (pkl load, params upload, the first request, "
        f"paste, render); {len(res_cli['scores'])} detections, "
        f"{int(shown.sum())} at >= {DEMO_THRESH} (classes "
        f"{sorted(set(res['classes'][shown].tolist()))}), {masks_drawn} masks and "
        f"{kps_drawn} keypoints above kp_thresh drawn; launches {launches} ({reruns} NMS "
        f"prefilter reruns); warm run_image {request_ms:.1f} ms, {engine_launches} forward "
        f"launches; file {written.shape[1]}x{written.shape[0]} equal "
        f"to vis_one_image of run_image's result: {np.array_equal(written[:, :, ::-1], drawn)}")
    check(written is not None and written.shape == im.shape,
          f"the demo's output does not decode to {im.shape}")
    check(np.array_equal(written[:, :, ::-1], drawn),
          "the demo's output differs from vis_one_image of run_image's result")
    if device.type == "cuda":
        check(launches["roi_align_bwd"] == 0 and launches["roi_align_fwd"] >= 2
              and launches["roi_align_fwd"] % 2 == 0
              and engine_launches == launches["roi_align_fwd"],
              f"demo launches {launches}, run_image {engine_launches}: expected 2 forward "
              "a request")
    check(shown.any() and not (drawn == im).all(), "the demo drew nothing")
    check(masks_drawn > 0 if cfg.use_mask else kps_drawn > 0,
          "no mask or keypoint above its threshold was drawn")
    return launches, request_ms, engine, im


def trace_kernel_events(logdir):
    """Kernel events of the trace files under `logdir` whose name holds the
    forward kernel's symbol."""
    names = []
    for f in os.listdir(logdir):
        with open(os.path.join(logdir, f)) as fh:
            events = json.load(fh)["traceEvents"]
        names += [e["name"] for e in events
                  if e.get("cat") == "kernel" and "roi_align_fwd_kernel" in e.get("name", "")]
    return names


def phase_demo(device, smi, rle_build_s, kept, infer, tag="26 demo", batch=BATCH,
               height=HEIGHT, width=WIDTH):
    """Phase 26: the native RLE on phase 9's data, the demo on both presets,
    profiling (device_timer of phase 4's request, a trace of a demo request)
    and debug (checked around a flagship request, with a NaN pixel;
    assert_finite_tree). Returns the demo launches and the times."""
    import tempfile

    import torch

    from detectorch_tpu_torch.config import PRESETS, TestConfig
    from detectorch_tpu_torch.models.detector import make_inference_fn
    from detectorch_tpu_torch.utils.debug import assert_finite_tree, checked
    from detectorch_tpu_torch.utils.profiling import device_timer, trace

    rle_times = phase_rle_native(kept, rle_build_s)
    # the demo's two runs and run_image give the same bits: no algorithm
    # picked by timing, none that accumulates with atomics
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as root:
            launches, ms = {}, {}
            launches["demo_keypoint"], ms["demo_keypoint"], _, _ = demo_path(
                device, root, KP_PRESET, tag + " kp")
            launches["demo"], ms["demo"], engine, im = demo_path(device, root, PRESET, tag)

            logdir = os.path.join(root, "trace")
            with trace(logdir):
                engine.run_image(im)
            kernels = trace_kernel_events(logdir)
            log(f"[{tag}] utils/profiling.trace around one demo request: "
                f"{len(os.listdir(logdir))} trace file, {len(kernels)} kernel events of "
                f"roi_align_fwd_kernel ({kernels[0] if kernels else 'none'})")
            if device.type == "cuda":
                check(len(kernels) >= 2, "the trace holds no forward kernel event")

            # debug: checked around the flagship request on the demo image's blob
            fwd = make_inference_fn(PRESETS[PRESET], TestConfig())
            args = engine._upload([engine.preprocess(im)[0]])
            out = checked(fwd)(engine.params, *args)
            assert_finite_tree(out, "out")
            bad = args[0].clone()
            bad[0, 100, 200, 1] = float("nan")
            try:
                checked(fwd)(engine.params, bad, *args[1:])
                raised = None
            except ValueError as err:
                raised = str(err)
            log(f"[{tag}] utils/debug: checked(make_inference_fn) on the demo image's "
                f"{tuple(args[0].shape)} blob passes (as JAX's checked on the CPU test); "
                f"assert_finite_tree of its outputs passes; one NaN pixel: {raised!r}")
            check(raised is not None and raised.startswith("nan generated by"),
                  "checked did not raise on a NaN pixel")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # profiling: device_timer of phase 4's request
    params, rate = infer
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    batch_args = _batch(gen, batch, height, width, device)
    fwd4 = make_inference_fn(PRESETS[PRESET], TestConfig())
    serial = device_timer(fwd4, params, *batch_args, iters=3, pipeline=False) * 1e3
    pipelined = device_timer(fwd4, params, *batch_args, iters=3, pipeline=True) * 1e3
    log(f"[{tag}] utils/profiling.device_timer of phase 4's request (batch {batch}, "
        f"{height}x{width}, bf16): serial {serial:.1f} ms ({batch * 1e3 / serial:.2f} img/s), "
        f"pipelined {pipelined:.1f} ms ({batch * 1e3 / pipelined:.2f} img/s); phase 4's timed "
        f"requests {rate:.2f} img/s ({batch * 1e3 / rate:.1f} ms) on {smi}")
    return launches, {**ms, "device_timer_serial_ms": serial,
                      "device_timer_pipelined_ms": pipelined,
                      "phase4_ms": batch * 1e3 / rate}, rle_times


# ------------------------------------------------- production AP (phase 27)

# the ladder of tools/production_ap per preset, as substrings of the rows
# after row 1 (empty: all six): every row on the FPN presets; rows 1, 2 and
# 6 on C4 and keypoint, whose rows 3-5 would take the phase further past
# its ~150 s (the CLI runs them: python -m detectorch_tpu_torch.tools.production_ap)
PAP_PLAN = (
    ("e2e_mask_rcnn_R-50-FPN_2x", ()),
    ("e2e_faster_rcnn_R-50-FPN_2x", ()),
    ("e2e_mask_rcnn_R-50-C4_2x", ("fp32/kernel", "production")),
    (KP_PRESET, ("fp32/kernel", "production")),
)
# box AP of every row above this (probes that detect nothing are refused, as
# the CPU parity tests refuse them)
PAP_MIN_BOX_AP = 0.05
# fp32 through the kernels against the fp32 plain path: AP@[.5:.95] of each
# task within this, a sanity bound ~5x the summation-order change the TPU
# study saw (PARITY.md), not a quality claim
PAP_ROW2_TOL = 0.01


def phase_production_ap(device, smi, plan=PAP_PLAN, images=None, tag="27 production AP"):
    """Phase 27: tools/production_ap's ladder on each preset of `plan`, from
    probe weights the card fits on the port's data/synth sets. Every stat
    finite, box AP above PAP_MIN_BOX_AP in every row, row 2 within
    PAP_ROW2_TOL of row 1 on each task's AP, and the forward kernel launched
    once per request for the box call and once more for the mask or
    keypoint call in each card row (row 1: none; the backward: none).
    Returns the launches by preset and row, and the rows' summary."""
    import tempfile

    import numpy as np

    from detectorch_tpu_torch.config import PRESETS
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd, roi_align_fwd
    from detectorch_tpu_torch.tools import production_ap as pap

    t_phase = time.perf_counter()
    launches, summary = {}, {}
    with tempfile.TemporaryDirectory() as root:
        roi_align_fwd.launches = roi_align_bwd.launches = 0
        for preset, variants in plan:
            cfg = PRESETS[preset]
            t0 = time.perf_counter()
            rows = pap.run_ladder(preset, variants, device, root, images=images, echo=False)
            per_request = 1 + int(cfg.use_mask) + int(cfg.keypoint is not None)
            for r in rows:
                on_card = r["row"] > 1 and device.type == "cuda"
                aps = ", ".join(f"{t} {v[0]:.4f}" for t, v in r["stats"].items())
                changes = ", ".join(f"{t} {d:+.5f}"
                                    for t, d in r.get("ap_delta_vs_row1", {}).items())
                delta = (f"; AP change {changes}, max |change| of any stat "
                         f"{r['max_delta_vs_row1']:.5f}" if r["row"] > 1 else "")
                log(f"[{tag}] {preset} row {r['row']} {r['variant']} ({r['device']}, batch "
                    f"{r['batch']}): {aps}{delta}; launches {r['launches']} over "
                    f"{r['requests']} requests; {r['seconds']:.1f} s")
                check(all(np.isfinite(v).all() for v in r["stats"].values()),
                      f"{preset} row {r['row']}: a COCO stat is not finite")
                check(r["bbox_ap"] > PAP_MIN_BOX_AP,
                      f"{preset} row {r['row']}: box AP {r['bbox_ap']:.4f} <= {PAP_MIN_BOX_AP}")
                expected = per_request * r["requests"] if on_card else 0
                check(r["launches"] == {"roi_align_fwd": expected, "roi_align_bwd": 0},
                      f"{preset} row {r['row']}: launches {r['launches']}, expected "
                      f"{expected} forward ({per_request} a request) and no backward")
            if device.type == "cuda":
                check(len(rows) > 1 and rows[1]["variant"] == "fp32/kernel",
                      f"{preset}: the ladder ran no fp32 kernel row")
                worst = max(abs(d) for d in rows[1]["ap_delta_vs_row1"].values())
                check(worst <= PAP_ROW2_TOL,
                      f"{preset}: fp32 through the kernels moved AP by {worst:.5f} against the "
                      f"plain path (bound {PAP_ROW2_TOL})")
            launches[preset] = {r["variant"]: r["launches"] for r in rows}
            summary[preset] = {"seconds": time.perf_counter() - t0, "rows": [
                {k: r[k] for k in ("row", "variant", "device", "batch", "requests", "launches",
                                   "seconds", "stats")}
                | {k: r[k] for k in ("ap_delta_vs_row1", "max_delta_vs_row1") if k in r}
                for r in rows]}
        total = {"roi_align_fwd": roi_align_fwd.launches, "roi_align_bwd": roi_align_bwd.launches}
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] {len(plan)} presets in {seconds:.1f} s ("
        + ", ".join(f"{p} {s['seconds']:.1f} s" for p, s in summary.items())
        + f"), probe fits included; launches in the phase {total} on {smi}")
    if device.type == "cuda":
        check(total["roi_align_fwd"] > 0, "phase 27 launched no forward kernel")
    return launches, {"seconds": seconds, "presets": summary}


# --- the measurement tools (phase 28) -------------------------------------

TOOL_ITERS = 5
TOOL_EVAL_IMAGES = 48
STAGE_ITERS = 3


def counted(run):
    """run() with both kernels' counts set to 0 just before it; returns
    (its result, the counts read just after)."""
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd, roi_align_fwd
    from detectorch_tpu_torch.tools.measure import launches

    roi_align_fwd.launches = roi_align_bwd.launches = 0
    out = run()
    return out, launches()


def phase_tools(device, smi, infer_rate, tag="28 tools"):
    """Phase 28: the port's measurement tools in process, on the card, at
    the sizes of phases 4, 7 and 10: tools/bench at batch 8 (inference and
    BENCH_MODE=train), tools/profile_e2e_train with masks, tools/bench_e2e
    on 48 synthetic images at batch 8, tools/profile_stages on the flagship
    and on C4, then tools/profile_mfu (the matmul rate, the FLOPs of the
    flagship request, of the Fast R-CNN step and of the e2e steps, and the
    MFU of phase 4's and this phase's rates and steps). Checks each tool's
    launches against the kernel table, every rate finite and above 0, the
    staged requests equal to the fused ones (inside profile_stages), the
    flagship's count equal to its closed form plus roi_align_work's
    operations, and vs_baseline null. Returns (launches by tool, the tools'
    lines)."""
    import math
    import tempfile

    import torch

    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.config import PRESETS, TestConfig
    from detectorch_tpu_torch.tools import (
        bench,
        bench_e2e,
        profile_e2e_train,
        profile_mfu,
        profile_stages,
    )

    t_phase = time.perf_counter()
    per_batch = {"BENCH_PER_DEV_BATCH": str(BATCH), "BENCH_ITERS": str(TOOL_ITERS)}
    launches, lines = {}, {}

    def timed(name, run):
        t0 = time.perf_counter()
        out, launches[name] = counted(run)
        log(f"[{tag}] {name}: {time.perf_counter() - t0:.1f} s of command, launches in the "
            f"call {launches[name]}")
        torch.cuda.empty_cache()
        return out

    def rate_ok(name, v):
        check(v is not None and math.isfinite(v) and v > 0, f"{name}: rate {v}")

    # inference: a build request, a warm one, then TOOL_ITERS timed, 2 launches each
    b = timed("bench", lambda: bench.main(per_batch))
    check(b["vs_baseline"] is None, "bench: vs_baseline is not null")
    check(b["launches"] == {"roi_align_fwd": 2 * TOOL_ITERS, "roi_align_bwd": 0},
          f"bench: {b['launches']} in {TOOL_ITERS} requests, expected 2 forward each")
    rate_ok("bench", b["value"])
    # the Fast R-CNN step: 1 forward (no mask branch) and 1 backward a step
    t = timed("bench_train", lambda: bench.main({**per_batch, "BENCH_MODE": "train"}))
    check(t["vs_baseline"] is None, "bench train: vs_baseline is not null")
    check(t["launches"] == {"roi_align_fwd": TOOL_ITERS, "roi_align_bwd": TOOL_ITERS},
          f"bench train: {t['launches']} in {TOOL_ITERS} steps, expected 1 + 1 each")
    rate_ok("bench train", t["value"])
    # the e2e Mask R-CNN step: 2 forward and 2 backward a step
    e = timed("profile_e2e_train", lambda: profile_e2e_train.main(
        {"PROFILE_E2E_MASKS": "1", "PROFILE_E2E_ITERS": str(TOOL_ITERS)}))
    check(e["launches"] == {"roi_align_fwd": 2 * TOOL_ITERS, "roi_align_bwd": 2 * TOOL_ITERS},
          f"profile_e2e_train: {e['launches']} in {TOOL_ITERS} steps, expected 2 + 2 each")
    check(math.isfinite(e["loss"]), f"profile_e2e_train: loss {e['loss']}")
    rate_ok("profile_e2e_train", e["images_per_sec"])
    # eval: 2 forward launches a batch
    with tempfile.TemporaryDirectory() as root:
        ev = timed("bench_e2e", lambda: bench_e2e.main(
            ["--n", str(TOOL_EVAL_IMAGES), "--batch", str(BATCH), "--root", root]))
    check(ev["launches"] == {"roi_align_fwd": 2 * ev["batches"], "roi_align_bwd": 0},
          f"bench_e2e: {ev['launches']} in {ev['batches']} batches, expected 2 forward each")
    check(ev["detections"] > 0 and ev["images"] == TOOL_EVAL_IMAGES, f"bench_e2e: {ev}")
    rate_ok("bench_e2e", ev["images_per_sec"])
    # stages: the flagship through the CLI, C4 with c4_weights
    stage_lines = {}
    for preset in (PRESET, C4_PRESET):
        def run_stages(preset=preset):
            if preset == PRESET:
                return profile_stages.main(["--iters", str(STAGE_ITERS)])
            cfg = PRESETS[preset]
            params = params_to_device(params_from_jax(c4_weights(cfg)), device)
            inputs = tuple(torch.from_numpy(a).to(device)
                           for a in bench.inference_inputs(BATCH, HEIGHT, WIDTH))
            return profile_stages.profile(params, cfg, TestConfig(), inputs, device,
                                          iters=STAGE_ITERS)

        res = timed(f"profile_stages {preset}", run_stages)
        per_request = {k: sum(c[k] for _, _, c in res["stages"])
                       for k in ("roi_align_fwd", "roi_align_bwd")}
        check(per_request == {"roi_align_fwd": 2, "roi_align_bwd": 0},
              f"profile_stages {preset}: {per_request} a request, expected 2 forward")
        rate_ok(f"profile_stages {preset}", res["request_ms"])
        stage_lines[preset] = {"stages": [(n, ms) for n, ms, _ in res["stages"]],
                               "launches_per_request": per_request,
                               "request_ms": res["request_ms"],
                               "stage_sum_ms": res["stage_sum_ms"]}
        log(f"[{tag}] {preset} in stages (ms): "
            + ", ".join(f"{n} {ms:.1f}" for n, ms, _ in res["stages"])
            + f"; sum {res['stage_sum_ms']:.1f}, fused request {res['request_ms']:.1f}; the "
              "staged outputs equal the fused request's bit for bit")
        del res
    launches["profile_stages"] = launches.pop(f"profile_stages {PRESET}")
    launches["profile_stages_c4"] = launches.pop(f"profile_stages {C4_PRESET}")
    # FLOPs and MFU
    m = timed("profile_mfu", lambda: profile_mfu.run(
        device, BATCH, HEIGHT, WIDTH, steps=True,
        rates={"phase 4": infer_rate, "phase 28 bench": b["value"]},
        step_ms={"fast_rcnn_train_step": sum(t["ms"]) / len(t["ms"]),
                 PRESET: e["ms_per_step"]}))
    # whole calls, warm-ups included: a build and a warm request then the
    # timed ones; a first step then the timed ones; per preset the fused
    # reference, iters + 1 staged and iters fused requests; the counts of
    # one request and of the Fast R-CNN, e2e Faster, Mask and Keypoint steps
    expected = {"bench": (2 * (TOOL_ITERS + 2), 0), "bench_train": (TOOL_ITERS + 1,) * 2,
                "profile_e2e_train": (2 * (TOOL_ITERS + 1),) * 2,
                "profile_stages": (2 * (2 * STAGE_ITERS + 2), 0),
                "profile_stages_c4": (2 * (2 * STAGE_ITERS + 2), 0),
                "profile_mfu": (2 + 1 + 1 + 2 + 2, 1 + 1 + 2 + 2)}
    for name, (fwd, bwd) in expected.items():
        check(launches[name] == {"roi_align_fwd": fwd, "roi_align_bwd": bwd},
              f"{name}: {launches[name]} in the whole call, expected {fwd} + {bwd}")
    flag = m["flops"][0]
    cfg = PRESETS[PRESET]
    closed = profile_mfu.inference_closed_form(cfg, TestConfig(), BATCH, HEIGHT, WIDTH)
    count = flag["count"]
    check(count["layers"] == closed and flag["flops"] == closed + count["roi_align"]["fwd"],
          f"flagship FLOPs {flag['flops']} != closed form {closed} + RoIAlign "
          f"{count['roi_align']['fwd']}")
    check(count["roi_align_calls"] == {"fwd": 2, "bwd": 0}, f"counted calls {count}")
    for row in m["matmul"] + m["mfu"]:
        rate_ok("profile_mfu", row.get("tflops", row.get("achieved_tflops")))
    for row in m["flops"]:
        check(row["flops"] > 0, f"profile_mfu: {row['preset']} counted no FLOPs")
    log(f"[{tag}] flagship request {flag['flops_per_image'] / 1e9:.2f} GFLOP/image (conv and "
        f"linear {count['layers'] / BATCH / 1e9:.2f}, equal to the closed form; RoIAlign "
        f"{count['roi_align']['fwd'] / BATCH / 1e9:.3f}); steps: "
        + ", ".join(f"{r['preset']} {r['flops'] / 1e12:.3f} TFLOP" for r in m["flops"][1:])
        + "; MFU: " + ", ".join(
            f"{r.get('rate_from', r['preset'])} {r['mfu']:.4f} ({r['share_of_sustained']} "
            "of the matmul rate)" for r in m["mfu"]))
    log(f"[{tag}] phase 28: {time.perf_counter() - t_phase:.1f} s on {smi}")
    lines.update(bench=b, bench_train=t, profile_e2e_train=e, bench_e2e=ev,
                 profile_stages=stage_lines,
                 profile_mfu={"matmul": m["matmul"], "mfu": m["mfu"],
                              "flops": [{k: v for k, v in r.items() if k != "count"}
                                        for r in m["flops"]]},
                 seconds=time.perf_counter() - t_phase)
    return launches, lines


def per_kernel(launches, kernel):
    """One kernel's counts of a nested {path: counts} tree."""
    if isinstance(launches, dict) and kernel in launches:
        return launches[kernel]
    if isinstance(launches, dict):
        return {k: per_kernel(v, kernel) for k, v in launches.items()}
    return [per_kernel(v, kernel) for v in launches]


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
    rle_build_s = phase_build()
    summary = phase_kernel(device)
    infer_launches, infer_rate, infer_params = phase_main_path(device, card=smi)
    phase_fp32_parity(device, infer_params)
    bwd_summary = phase_bwd_kernel(device)
    train_launches, _ = phase_train(device, card=smi)
    phase_fp32_grads(device)
    kept = {}
    eval_launches, eval_rate = phase_eval(device, card=smi, keep=kept)
    e2e_launches, e2e_rate = phase_e2e_train(device, card=smi)
    phase_e2e_fp32_grads(device)
    c4 = phase_c4(device, smi)
    kp = phase_kp(device, smi)
    torch.cuda.empty_cache()
    world1 = phase_world1(device, card=smi, e2e_ms=BATCH * 1e3 / e2e_rate)
    torch.cuda.empty_cache()
    world2 = phase_parallel(device, card=smi, eval_rate=eval_rate)
    dryrun = phase_dryrun()
    torch.cuda.empty_cache()
    demo_launches, demo_ms, rle_times = phase_demo(device, smi, rle_build_s, kept,
                                                   (infer_params, infer_rate))
    del infer_params, kept
    torch.cuda.empty_cache()
    pap_launches, pap = phase_production_ap(device, smi)
    torch.cuda.empty_cache()
    tool_launches, tool_lines = phase_tools(device, smi, infer_rate)
    parallel_launches = {
        "world1_nccl_e2e_training": world1["launches"],
        "world2_e2e_training": [r["step_launches"] for r in world2],
        "world2_inference": [{m: {"roi_align_fwd": v["launches"], "roi_align_bwd": 0}
                              for m, v in r["inference"].items()} for r in world2],
        "world2_eval": [{"roi_align_fwd": r["eval"]["launches"], "roi_align_bwd": 0}
                        for r in world2],
        "dryrun": [{"training": dict(zip(("roi_align_fwd", "roi_align_bwd"),
                                         r["launches"]["train"])),
                    "inference": {"roi_align_fwd": r["launches"]["inference"][0],
                                  "roi_align_bwd": 0}} for r in dryrun],
    }
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
                             "e2e_training": e2e_launches["roi_align_fwd"],
                             **{k: v["roi_align_fwd"] for k, v in c4["launches"].items()},
                             **{k: v["roi_align_fwd"] for k, v in kp["launches"].items()},
                             **per_kernel(parallel_launches, "roi_align_fwd"),
                             **per_kernel(demo_launches, "roi_align_fwd"),
                             "production_ap": per_kernel(pap_launches, "roi_align_fwd"),
                             **per_kernel(tool_launches, "roi_align_fwd")},
        "max_abs_err": summary["max_abs_err"],
        "c4_max_abs_err": c4["kernels"]["fwd_err"],
        "keypoint_max_abs_err": max(r["max_abs_err"] for r in kp["calls"]["fwd"]),
        "ms": summary["ms"],
        "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"],
        "bound_by": summary["bound_by"],
        "library_ms": None,  # no PyTorch call computes caffe2 RoIAlign
        "calls": summary["calls"] + c4["kernels"]["fwd_calls"] + kp["calls"]["fwd"],
    }, {
        "name": "roi_align_bwd",
        "route": "cuda",
        "source": f"{source}/roi_align_bwd.cu",
        "replaces": f"{replaces}:489",
        "launches": e2e_launches["roi_align_bwd"],
        "launches_by_path": {"training": train_launches["roi_align_bwd"],
                             "e2e_training": e2e_launches["roi_align_bwd"],
                             **{k: v["roi_align_bwd"] for k, v in c4["launches"].items()
                                if "training" in k},
                             **{k: v["roi_align_bwd"] for k, v in kp["launches"].items()
                                if "training" in k},
                             **per_kernel(parallel_launches, "roi_align_bwd"),
                             "production_ap": per_kernel(pap_launches, "roi_align_bwd"),
                             **per_kernel(tool_launches, "roi_align_bwd")},
        "max_abs_err": bwd_summary["max_abs_err"],
        "c4_max_abs_err": c4["kernels"]["bwd_err"],
        "keypoint_max_abs_err": max(r["max_abs_err"] for r in kp["calls"]["bwd"]),
        "ms": bwd_summary["ms"],
        "plain_ms": bwd_summary["plain_ms"],
        "bound_ms": bwd_summary["bound_ms"],
        "bound_by": bwd_summary["bound_by"],
        "library_ms": None,  # nor its feature gradient
        "calls": bwd_summary["calls"] + c4["kernels"]["bwd_calls"] + kp["calls"]["bwd"],
    }]
    parallel = {
        "world1_nccl": {k: world1[k] for k in ("ms_per_step", "plain_ms_per_step",
                                               "allreduce_bucketed_ms", "allreduce_per_leaf_ms")},
        "phase10_ms_per_step": BATCH * 1e3 / e2e_rate,
        "world2_gloo_one_card": [{"rank": r["rank"], "e2e_fp32_step_ms": r["step_ms"],
                                  "eval_images_per_sec": r["eval"]["images_per_sec"]}
                                 for r in world2],
        "phase9_eval_images_per_sec": eval_rate,
    }
    log(smi)
    log(json.dumps({"kernels": kernels, "parallel": parallel, "rle_native": rle_times,
                    "demo": demo_ms, "production_ap": pap, "bench": tool_lines}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The card's sustained bf16 matmul rate, the FLOPs of the flagship request
and of the training steps, and the MFU they give.

The counterpart of the JAX repository's ``examples/profile_mfu.py`` (and of
``PROFILE_E2E_COST`` in ``examples/profile_e2e_train.py``):

  python -m detectorch_tpu_torch.tools.profile_mfu            # on the card
  BENCH_IMG_PER_SEC=110 python -m detectorch_tpu_torch.tools.profile_mfu --steps all
  python -m detectorch_tpu_torch.tools.profile_mfu --device cpu --batch 1   # the count alone

(a) The sustained bf16 matmul rate: a chain of 32 dependent
``torch.matmul``s (each followed by a 1/size scale, as JAX's chain) at
2048^3, 4096^3 and 8192^3, timed by CUDA events over 6 chains. A yardstick
of the card, not a port of a kernel. The CPU has no such rate: --device cpu
skips it.

(b) FLOPs of one call (``tools/measure.count_flops``): the conv and linear
layers, forward and backward, as ``torch.utils.flop_counter.FlopCounterMode``
counts them, plus both RoIAlign kernels' operations from their inputs'
shapes and live taps (``measure.roi_align_work``), which the counter cannot
see through a ctypes launch. Elementwise work is not counted (XLA's cost
analysis, which the JAX script reads, counts it). The flagship request
(e2e_mask_rcnn_R-50-FPN_2x at --batch 8, 832x1344, bench's inputs) is also
counted in closed form from its shapes (``inference_closed_form``), and the
two must agree. ``--steps all`` adds the Fast R-CNN training step (bench's
train mode) and the e2e Faster, Mask and Keypoint R-CNN steps
(``tools/profile_e2e_train``'s batch).

(c) MFU: BENCH_IMG_PER_SEC (a measured inference rate) times the FLOPs per
image, and ``--step-ms NAME=MS`` for a step, over the H100 SXM data sheet's
989 TFLOP/s dense bf16, with the card's power limit beside it, and as a
share of (a)'s best rate.

One JSON line per measurement, each naming its device.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
from detectorch_tpu_torch.config import PRESETS, TestConfig
from detectorch_tpu_torch.models.resnet import STAGE_BLOCKS, STAGES
from detectorch_tpu_torch.tools import measure

FLAGSHIP = "e2e_mask_rcnn_R-50-FPN_2x"
MATMUL_SIZES = (2048, 4096, 8192)
E2E_PRESETS = ("e2e_faster_rcnn_R-50-FPN_2x", "e2e_mask_rcnn_R-50-FPN_2x",
               "e2e_keypoint_rcnn_R-50-FPN_1x")
PEAK_NOTE = "989 TFLOP/s dense bf16, NVIDIA's H100 SXM data sheet"


def sustained_matmul(device: torch.device, size: int, chain: int = 32, iters: int = 6):
    """(TFLOP/s, ms per matmul) of a chain of `chain` dependent bf16
    matmuls, `iters` chains timed by CUDA events after a warm chain."""
    x = torch.from_numpy(np.random.RandomState(0).randn(size, size)).to(device, torch.bfloat16)
    w = torch.from_numpy(np.random.RandomState(1).randn(size, size)).to(device, torch.bfloat16)
    inv = 1.0 / size

    def run():
        c = x
        for _ in range(chain):
            c = torch.matmul(c, w) * inv  # the scale keeps the chain finite
        return c

    run()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = run()
    stop.record()
    torch.cuda.synchronize(device)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("the matmul chain overflowed")
    ms = start.elapsed_time(stop) / (iters * chain)
    return 2.0 * size ** 3 / (ms * 1e-3) / 1e12, ms


# -- closed form ---------------------------------------------------------------

def _out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def _taps(n: int, k: int, stride: int, pad: int, padding_taps: bool) -> int:
    """The taps of a conv along one axis of length n: every output times k,
    or only the taps that land inside the input."""
    out = _out(n, k, stride, pad)
    if padding_taps:
        return out * k
    return sum(0 <= o * stride - pad + t < n for o in range(out) for t in range(k))


class _Layers:
    """A running sum of the conv and linear layers' FLOPs (an FMA is 2).
    With padding_taps False a conv counts only its taps inside the input,
    as XLA's cost analysis does."""

    def __init__(self, padding_taps: bool = True):
        self.flops = 0
        self.padding_taps = padding_taps

    def conv(self, b, h, w, cin, cout, k, stride=1, pad=0):
        taps = (_taps(h, k, stride, pad, self.padding_taps)
                * _taps(w, k, stride, pad, self.padding_taps))
        self.flops += 2 * b * taps * cout * cin
        return _out(h, k, stride, pad), _out(w, k, stride, pad)

    def deconv(self, b, h, w, cin, cout, k, groups=1):
        """A stride-2 transposed conv: every input pixel meets the kernel."""
        self.flops += 2 * b * h * w * cin * (cout // groups) * k * k
        return 2 * h, 2 * w

    def linear(self, rows, cin, cout):
        self.flops += 2 * rows * cin * cout

    def stage(self, b, h, w, cin, cout, blocks, stride):
        """A ResNet stage of bottlenecks, the stride on branch2a and branch1."""
        mid = cout // 4
        for i in range(blocks):
            s = stride if i == 0 else 1
            if i == 0:
                self.conv(b, h, w, cin, cout, 1, s)
            ho, wo = self.conv(b, h, w, cin if i == 0 else cout, mid, 1, s)
            self.conv(b, ho, wo, mid, mid, 3, 1, 1)
            self.conv(b, ho, wo, mid, cout, 1)
            h, w = ho, wo
        return h, w


def inference_closed_form(cfg, test_cfg, batch: int, height: int, width: int,
                          padding_taps: bool = True) -> int:
    """The conv and linear layers' FLOPs of one ``make_inference_fn``
    request of `batch` images of height x width, counted by hand from the
    architecture: the ResNet body (stem, stages; res5 on FPN), the FPN
    laterals and outputs, the RPN head on every level, the box head on
    post_nms_top_n rois per image (fc6/fc7, or C4's res5) and its
    predictors, and the mask or keypoint head on the detection slots. A
    conv counts every tap (FlopCounterMode's convention: the card computes
    the zero padding too), or with padding_taps False only the taps inside
    its input (XLA's); a stride-2 transposed conv's taps are all inside."""
    t = _Layers(padding_taps)
    blocks = STAGE_BLOCKS[cfg.arch]
    h, w = t.conv(batch, height, width, 3, 64, 7, 2, 3)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # the max-pool
    maps, cin = [], 64
    for i in range(4 if cfg.use_fpn else 3):
        cout = STAGES[i][1]
        h, w = t.stage(batch, h, w, cin, cout, blocks[i], 1 if i == 0 else 2)
        maps.append((h, w, cout))
        cin = cout
    if cfg.use_fpn:
        ch = cfg.fpn.channels
        for h, w, c in maps:
            t.conv(batch, h, w, c, ch, 1)          # lateral
            t.conv(batch, h, w, ch, ch, 3, 1, 1)   # output
        levels = [m[:2] for m in maps]
        if cfg.fpn.extra_level:
            levels.append(((maps[-1][0] + 1) // 2, (maps[-1][1] + 1) // 2))
        rpn_in, anchors = ch, len(cfg.anchors.aspect_ratios)
    else:
        levels, rpn_in, anchors = [maps[-1][:2]], maps[-1][2], cfg.anchors.num_anchors
    for h, w in levels:
        t.conv(batch, h, w, rpn_in, rpn_in, 3, 1, 1)
        t.conv(batch, h, w, rpn_in, anchors, 1)
        t.conv(batch, h, w, rpn_in, 4 * anchors, 1)
    rows, s = batch * cfg.rpn.post_nms_top_n, cfg.roi_size
    if cfg.use_fpn:
        t.linear(rows, s * s * cfg.fpn.channels, 1024)
        t.linear(rows, 1024, 1024)
        feat = 1024
    else:
        t.stage(rows, s, s, maps[-1][2], STAGES[3][1], blocks[3], 2)
        feat = STAGES[3][1]
    t.linear(rows, feat, cfg.num_classes)
    t.linear(rows, feat, 4 * cfg.num_classes)
    dets = batch * (test_cfg.detections_per_img + test_cfg.detections_tie_slack)
    roi_ch = cfg.fpn.channels if cfg.use_fpn else maps[-1][2]
    if cfg.use_mask:
        s = cfg.mask.roi_size
        if cfg.mask.head_type == "1up4convs":
            for _ in range(4):
                t.conv(dets, s, s, roi_ch, roi_ch, 3, 1, 1)
            hw, trunk = s, roi_ch
        else:  # 'upshare': res5 again
            hw, _ = t.stage(dets, s, s, roi_ch, STAGES[3][1], blocks[3], 2)
            trunk = STAGES[3][1]
        mh, mw = t.deconv(dets, hw, hw, trunk, 256, 2)
        t.conv(dets, mh, mw, 256, cfg.num_classes, 1)
    if cfg.keypoint is not None:
        kc, s, c = cfg.keypoint, cfg.keypoint.roi_size, roi_ch
        for _ in range(kc.num_convs):
            t.conv(dets, s, s, c, kc.conv_dim, 3, 1, 1)
            c = kc.conv_dim
        kh, kw = t.deconv(dets, s, s, c, kc.num_keypoints, 4)
        t.deconv(dets, kh, kw, kc.num_keypoints, kc.num_keypoints, 4, groups=kc.num_keypoints)
    return t.flops


# -- counts ----------------------------------------------------------------------

def inference_flops(cfg, test_cfg, device: torch.device, batch: int, height: int, width: int,
                    params: Optional[Dict] = None) -> Dict:
    """One request of bench's inputs under ``measure.count_flops``, beside
    its closed form. Returns the line's fields."""
    from detectorch_tpu_torch.models.detector import init_params, make_inference_fn
    from detectorch_tpu_torch.tools.bench import inference_inputs

    if params is None:
        params = params_from_jax(init_params(cfg, seed=0))
    params = params_to_device(params, device)
    inputs = [torch.from_numpy(a).to(device) for a in inference_inputs(batch, height, width)]
    fn = make_inference_fn(cfg, test_cfg)
    _, count = measure.count_flops(lambda: fn(params, *inputs))
    closed = inference_closed_form(cfg, test_cfg, batch, height, width)
    return {"program": "inference", "preset": cfg.name, "batch": batch,
            "hw": [height, width], "flops": count["flops"],
            "flops_per_image": count["flops"] / batch, "count": count,
            "closed_form_layers": closed, "closed_form_equal": closed == count["layers"]}


def step_counts(device: torch.device, height: int, width: int, batch: int) -> List[Dict]:
    """FLOPs per step of the Fast R-CNN train step (bench's train mode) and
    the e2e Faster, Mask and Keypoint R-CNN steps (profile_e2e_train's
    batch, in the height x width bucket)."""
    from detectorch_tpu_torch.tools import bench, profile_e2e_train

    out = []
    state, step, blobs = bench.train_setup(PRESETS[bench.TRAIN_PRESET], device, batch,
                                           height, width)
    _, count = measure.count_flops(lambda: step(state, blobs))
    out.append({"program": "fast_rcnn_train_step", "preset": bench.TRAIN_PRESET,
                "batch": batch, "flops": count["flops"], "count": count})
    del state, step, blobs
    for preset in E2E_PRESETS:
        state, step, blobs = profile_e2e_train.e2e_setup(PRESETS[preset], device, batch=batch,
                                                         blob_hw=(height, width))
        _, count = profile_e2e_train.step_flops(state, step, blobs)
        out.append({"program": "e2e_train_step", "preset": preset, "batch": batch,
                    "flops": count["flops"], "count": count})
        del state, step, blobs
    for row in out:
        row["flops_per_image"] = row["flops"] / batch
    return out


def mfu(flops_per_s: float, sustained_tflops: Optional[float]) -> Dict:
    return {"achieved_tflops": flops_per_s / 1e12,
            "mfu": flops_per_s / measure.BF16_DENSE_FLOPS_PER_S, "peak": PEAK_NOTE,
            "share_of_sustained": (flops_per_s / 1e12 / sustained_tflops
                                   if sustained_tflops else None)}


def run(device: torch.device, batch: int = 8, height: int = 832, width: int = 1344,
        steps: bool = False, rates: Optional[Dict[str, float]] = None,
        step_ms: Optional[Dict[str, float]] = None, matmul_sizes=MATMUL_SIZES) -> Dict:
    """(a), (b) and (c) on `device`: the MFU of each measured inference
    rate in `rates` ({label: img/s}) and of each step time in `step_ms`
    ({counted preset or program: ms}). Returns {"matmul": [...], "flops":
    [...], "mfu": [...]} of the printed lines."""
    dev_info = measure.device_info(device)
    lines = {"matmul": [], "flops": [], "mfu": []}
    best = None
    if device.type == "cuda":
        for size in matmul_sizes:
            tflops, ms = sustained_matmul(device, size)
            best = max(best or 0.0, tflops)
            lines["matmul"].append(measure.emit({
                "tool": "profile_mfu", "what": "matmul", "size": size, "chain": 32,
                "dtype": "bfloat16", "ms_per_matmul": ms, "tflops": tflops,
                "share_of_peak": tflops * 1e12 / measure.BF16_DENSE_FLOPS_PER_S,
                "device": dev_info}))
    flag = inference_flops(PRESETS[FLAGSHIP], TestConfig(), device, batch, height, width)
    lines["flops"].append(measure.emit({"tool": "profile_mfu", "what": "flops", **flag,
                                        "device": dev_info}))
    if steps:
        for row in step_counts(device, height, width, batch):
            lines["flops"].append(measure.emit({"tool": "profile_mfu", "what": "flops",
                                                **row, "device": dev_info}))
    for label, rate in (rates or {}).items():
        lines["mfu"].append(measure.emit({
            "tool": "profile_mfu", "what": "mfu", "program": "inference", "preset": FLAGSHIP,
            "rate_from": label, "images_per_sec": rate,
            **mfu(rate * flag["flops_per_image"], best), "device": dev_info}))
    for name, ms in (step_ms or {}).items():
        rows = [r for r in lines["flops"]
                if r["program"] != "inference" and name in (r["program"], r["preset"])]
        if not rows:
            raise ValueError(f"--step-ms {name}: no step of that name was counted (--steps all)")
        lines["mfu"].append(measure.emit({
            "tool": "profile_mfu", "what": "mfu", "program": rows[0]["program"],
            "preset": rows[0]["preset"], "ms_per_step": ms,
            **mfu(rows[0]["flops"] / (ms * 1e-3), best), "device": dev_info}))
    return lines


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the counts only)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", choices=("none", "all"), default="none",
                   help="also count the training steps' FLOPs")
    p.add_argument("--step-ms", action="append", default=[], metavar="NAME=MS",
                   help="a measured step time (NAME: a counted preset or program)")
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    from detectorch_tpu_torch.tools import bench

    args = parse_args(argv)
    device = measure.resolve_device(args.device, "profile_mfu")
    rate = os.environ.get("BENCH_IMG_PER_SEC")
    step_ms = dict((k, float(v)) for k, v in (s.split("=", 1) for s in args.step_ms))
    return run(device, args.batch, bench.HEIGHT, bench.WIDTH, steps=args.steps == "all",
               rates={"BENCH_IMG_PER_SEC": float(rate)} if rate else None, step_ms=step_ms)


if __name__ == "__main__":
    main()

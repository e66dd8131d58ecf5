"""What the measurement tools share: the device they run on and how it is
named, CUDA-event stage marks, the RoIAlign kernels' launch counts, the
FLOP count of a call, and the H100's rates.

Used by ``tools/{bench,bench_e2e,profile_e2e_train,profile_stages,
profile_mfu}`` and by ``chip_smoke.py``. Times come from CUDA events or
from the host clock after ``torch.cuda.synchronize()``; a time read on the
CPU is never a device number.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import time
from typing import Callable, Dict, List

import torch

from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd, roi_align_fwd

# the least time of a kernel call (NVIDIA's data sheet, H100 SXM at 700 W):
# its bytes over the memory rate, or its fp32 operations over the CUDA
# cores' rate, whichever is larger
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# the same data sheet's dense bf16 tensor-core rate: the MFU's denominator
BF16_DENSE_FLOPS_PER_S = 989e12

# the operators of the conv and linear layers, forward and backward, as
# FlopCounterMode names them; every other counted operator (the NMS's and
# the mask targets' batched products, the C4 plain RoIAlign's) is reported
# apart and left out of the model's FLOPs
LAYER_OPS = ("aten.convolution", "aten._convolution", "aten.convolution_backward",
             "aten.mm", "aten.addmm")


def resolve_device(spec: str, tool: str, how: str = "--device cpu") -> torch.device:
    """The device a tool runs on: the card unless `spec` asks for the CPU.
    Asked for the card without one, it raises; it never falls back."""
    device = torch.device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{tool} runs on the card, and torch.cuda.is_available() is False; "
                           f"{how} runs it on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def nvidia_smi() -> str:
    """nvidia-smi's name and power limit of the first card."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    return lines[0] if proc.returncode == 0 and lines else "not read"


def device_info(device: torch.device):
    """What a JSON line says of its device: "cpu", or the card's name, the
    count of cards and nvidia-smi's name and power limit."""
    if device.type != "cuda":
        return "cpu"
    return {"name": torch.cuda.get_device_name(device), "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi()}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak_memory(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_memory_gib(device: torch.device):
    """Peak device memory since ``reset_peak_memory`` (None on the CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def launches() -> Dict[str, int]:
    """The RoIAlign kernels' launch counts so far."""
    return {"roi_align_fwd": roi_align_fwd.launches, "roi_align_bwd": roi_align_bwd.launches}


def launches_since(start: Dict[str, int]) -> Dict[str, int]:
    now = launches()
    return {k: now[k] - start[k] for k in now}


def emit(line: Dict) -> Dict:
    """Print one JSON line and return it."""
    print(json.dumps(line), flush=True)
    return line


def host_ms(fn: Callable, device: torch.device):
    """(fn's result, its ms on the host clock, the device synchronised
    after it)."""
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


class StageMarks:
    """Marks between the stages of one call: a CUDA event per mark on the
    card (no synchronisation between stages), the host clock on the CPU;
    each stage also counts the RoIAlign launches made inside it. Call the
    object with a stage's name when the stage ends."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks: List = []
        self.counts: List[Dict[str, int]] = []
        self._mark("start")

    def _mark(self, name: str):
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(self.device))
        else:
            event = time.perf_counter()
        self.marks.append((name, event))
        self.counts.append(launches())

    def __call__(self, name: str) -> None:
        self._mark(name)

    def stages(self):
        """[(name, ms, launches)] of each stage, after the device is done."""
        synchronize(self.device)
        out = []
        for i in range(1, len(self.marks)):
            (_, a), (name, b) = self.marks[i - 1], self.marks[i]
            ms = a.elapsed_time(b) if self.device.type == "cuda" else (b - a) * 1e3
            out.append((name, ms, {k: self.counts[i][k] - self.counts[i - 1][k]
                                   for k in self.counts[i]}))
        return out


def roofline(nbytes: float, flops: float):
    """(bound_ms, bound_by) of a call that moves `nbytes` and does `flops`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roi_align_work(level_shapes, rois, bidx, levels, scales, pooled, channels,
                   sampling_ratio=2, max_grid=8):
    """What one RoIAlign call over these rois needs: the feature pixels its
    live samples' taps touch (each counted once) and the fp32 operations of
    its taps (an FMA per live tap and channel). The backward does the same
    operations."""
    from detectorch_tpu_torch.ops.roi_align import _bilinear_taps

    idx, wts, *_ = _bilinear_taps([s[:3] for s in level_shapes], rois, bidx, levels, scales,
                                  pooled, pooled, sampling_ratio, max_grid)
    live = wts[0] != 0  # hy * hx > 0 for every live sample
    pixels = torch.unique(torch.cat([i[live] for i in idx])).numel()
    return pixels, 2 * 4 * int(live.sum()) * channels


@contextlib.contextmanager
def recorded_roi_align():
    """The RoIAlign calls made in the block, forward and backward, on the
    CPU and on the card: {"fwd": [...], "bwd": [...]} of each call's
    geometry (``_Kernel.observers``)."""
    calls = {"fwd": [], "bwd": []}

    def keep(kind):
        def fn(shapes, rois, bidx, levels, *rest):
            calls[kind].append((shapes, rois.detach().clone(), bidx.clone(), levels.clone(),
                                *rest))
        return fn

    observers = [(roi_align_fwd, keep("fwd")), (roi_align_bwd, keep("bwd"))]
    for kernel, fn in observers:
        kernel.observers.append(fn)
    try:
        yield calls
    finally:
        for kernel, fn in observers:
            kernel.observers.remove(fn)


def roi_align_ops(calls) -> Dict[str, int]:
    """The fp32 operations of recorded RoIAlign calls (``roi_align_work``),
    by direction."""
    out = {}
    for kind, rows in calls.items():
        total = 0
        for shapes, rois, bidx, levels, scales, ph, pw, ratio, grid in rows:
            if ph != pw:
                raise ValueError("roi_align_work counts square bins")
            total += roi_align_work(shapes, rois, bidx, levels, scales, ph, shapes[0][-1],
                                    ratio, grid)[1]
        out[kind] = total
    return out


def count_flops(fn: Callable):
    """fn() once under ``torch.utils.flop_counter.FlopCounterMode``, with its
    RoIAlign calls recorded. Returns (fn's result, count): count["flops"] is
    the conv and linear layers' operations (LAYER_OPS, forward and
    backward) plus the RoIAlign kernels' (``roi_align_ops``: the counter
    cannot see a ctypes launch, and on the CPU the plain versions' operators
    are not the kernel's work); count["other_counted"] holds what the
    counter saw besides, by operator. The count does not depend on the
    device."""
    from torch.utils.flop_counter import FlopCounterMode

    with recorded_roi_align() as calls:
        with FlopCounterMode(display=False) as counter:
            out = fn()
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    layers = sum(n for op, n in by_op.items() if op in LAYER_OPS)
    roi = roi_align_ops(calls)
    return out, {"flops": layers + sum(roi.values()), "layers": layers, "roi_align": roi,
                 "roi_align_calls": {k: len(v) for k, v in calls.items()},
                 "layers_by_op": {op: n for op, n in by_op.items() if op in LAYER_OPS},
                 "other_counted": {op: n for op, n in by_op.items() if op not in LAYER_OPS}}

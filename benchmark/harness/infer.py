"""The inference cells: batches of blobs through the port's batched
inference entry, one closed-loop client, answers fetched to the host.

A run: set-up (weights from the seed through the checkpoint importer, the
traffic's pool, the warm-up requests that build the kernels), the measured
window, then with ``--trace 1`` a profiled stretch and a staged stretch,
then the check of the sampled requests against the reference.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from benchmark.harness import check, flops, program
from benchmark.harness.trace import Trace
from benchmark.harness.traffic import make_pool
from benchmark.harness.weights import make_blobs, stream_seed

WARM_REQUESTS = 2    # after the first request, which builds the kernels
SAMPLE_REQUESTS = 2  # requests of the window that the reference judges
TRACE_REQUESTS = 3   # under torch.profiler (--trace 1)
STAGE_REQUESTS = 3   # cut at the stage functions (--trace 1), after one more that warms


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _fetch_buffers(out, device):
    """Pinned host buffers for a request's detections and masks."""
    d = out.detections
    pin = device.type == "cuda"
    return [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
            for t in (d.boxes, d.scores, d.classes, d.valid, out.masks)]


def _fetch(out, bufs, device):
    """The answer on the host: detections and masks copied, then one wait."""
    d = out.detections
    for buf, t in zip(bufs, (d.boxes, d.scores, d.classes, d.valid, out.masks)):
        buf.copy_(t, non_blocking=True)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return bufs


def _p95(values):
    v = sorted(values)
    return v[max(0, int(np.ceil(0.95 * len(v))) - 1)]


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: Optional[Callable] = None) -> Dict:
    """One run of an inference cell. Returns {"e2e": {metric: value},
    "layer": context for the per-layer readers (with --trace 1),
    "checks": (correct, numbers), "attempted", "failed", "memory_peak_bytes",
    "trace": Trace or None}. `fault(fn, model_cfg, test_cfg)` (tests only)
    returns the timed entry broken underneath."""
    device = torch.device(device)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    blobs = make_blobs(cfg, seed, device)
    model_cfg, test_cfg = program.port_configs(cfg)
    params = program.load_params(blobs, model_cfg, device)
    marks.append(("weights", time.perf_counter()))
    pool = make_pool(mix, seed, device)
    fn = program.inference_fn(model_cfg, test_cfg, device)
    if fault is not None:
        fn = fault(fn, model_cfg, test_cfg)
    marks.append(("pool", time.perf_counter()))
    out = fn(params, *pool[0])
    bufs = [_fetch_buffers(out, device) for _ in pool]  # one set per batch of the pool
    spare = _fetch_buffers(out, device)  # for the traced run's requests
    marks.append(("first request", time.perf_counter()))
    for k in range(WARM_REQUESTS):
        _fetch(fn(params, *pool[k % len(pool)]), bufs[k % len(pool)], device)
    marks.append(("warm requests", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    log("set-up: " + ", ".join(f"{name} {b - a:.2f} s"
                               for (_, a), (name, b) in zip(marks[:-1], marks[1:])))

    kept, lat = {}, []
    start = time.perf_counter()
    k = 0
    while True:
        j = k % len(pool)
        t0 = time.perf_counter()
        out = fn(params, *pool[j])
        host = _fetch(out, bufs[j], device)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        kept[j] = (out, host)  # the latest answer to each batch
        k += 1
        if t1 - start >= seconds:
            break
    window_s = t1 - start
    batch = mix["batch"]
    e2e = {"infer_img_per_s": k * batch / window_s, "infer_request_ms_p95": _p95(lat) * 1e3,
           "setup_s": setup_s}
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)

    layer, tr = None, None
    if trace:
        layer, tr = _traced(cell, cfg, mix, params, model_cfg, test_cfg, fn, pool, spare,
                            device, e2e["infer_img_per_s"])
    del params, fn, out
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.RandomState(stream_seed(seed, 3) % 2 ** 32)
    served = sorted(kept)
    pick = rng.choice(len(served), min(SAMPLE_REQUESTS, len(served)), replace=False)
    samples = [(pool[served[i]], program.per_image(*kept[served[i]])) for i in sorted(pick)]
    kept.clear()
    t0 = time.perf_counter()
    numbers = check.judge(cfg, cell["roi_pre_margin"], blobs, samples)
    log(f"check: {time.perf_counter() - t0:.2f} s")
    return {"e2e": e2e, "layer": layer, "checks": check.verdict(numbers, cell["limits"]),
            "attempted": k * batch, "failed": 0, "memory_peak_bytes": peak, "trace": tr}


def _traced(cell, cfg, mix, params, model_cfg, test_cfg, fn, pool, bufs, device, img_per_s):
    """The profiled stretch (TRACE_REQUESTS requests under torch.profiler,
    fetched into `bufs`, apart from the window's answers, which are judged)
    and the staged one (STAGE_REQUESTS requests cut at the port's stage
    functions, CUDA events between stages)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = TRACE_REQUESTS
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("bench_window"):
                for r in range(n):
                    o = fn(params, *pool[r % len(pool)])
                    _fetch(o, bufs, device)
                    outs.append((r % len(pool), o))
                torch.cuda.synchronize(device)
        prof.export_chrome_trace(path)
        tr = Trace(path, "bench_window")

    stages = {name: 0.0 for name in program.STAGES}
    for r in range(STAGE_REQUESTS + 1):
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()
        names = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append(e)
            names.append(name)

        program.staged_request(params, model_cfg, test_cfg, pool[r % len(pool)], mark)
        torch.cuda.synchronize(device)
        if r:  # the first warms
            for name, a, b in zip(names, events[:-1], events[1:]):
                stages[name] += a.elapsed_time(b) / STAGE_REQUESTS

    bounds_ms, roi_ops = 0.0, 0.0
    for j, o in outs:
        b = pool[j]
        calls = flops.roi_align_calls(cfg, mix["bucket"], [
            o.rois, o.detections.boxes * b.im_scale[:, None, None]])
        bounds_ms += sum(c[0] for c in calls)
        roi_ops += sum(c[1] for c in calls)
    images = n * mix["batch"]
    per_image = (flops.request_layer_flops(cfg, mix["batch"], *mix["bucket"]) / mix["batch"]
                 + roi_ops / images)
    layer = {"stages_ms": stages, "trace": tr, "requests": n, "images": images,
             "img_per_s": img_per_s, "flops_per_image": per_image,
             "roi_align_fwd": {"bound_ms": bounds_ms,
                               "kernel_ms": tr.kernel_s("roi_align_fwd") * 1e3,
                               "launches": tr.kernel_count("roi_align_fwd")}}
    return layer, tr

"""Profiling helpers.

The port's counterpart of ``detectorch_tpu/utils/profiling.py``:
  * `trace(logdir)` — context manager around ``torch.profiler`` (with CUDA
    activities when a card is present) that writes a Chrome / Perfetto
    trace file under `logdir`, as ``jax.profiler`` writes its capture there;
  * `device_timer` — sustained seconds per call of a function whose work
    runs asynchronously on a card, waiting for each call's work to finish.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the with-block into
    ``logdir/trace-<pid>-<ns>.json`` (written when the block ends, also when
    it raises)."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    if isinstance(out, (list, tuple)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def _mark(out):
    """A marker of the work that produced `out`: an event recorded on the
    current stream of its first tensor leaf's card, or None for a result
    on the CPU (complete when the call returns)."""
    leaf = _first_tensor(out)
    if leaf is None or leaf.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(leaf.device))
    return event


def _wait(marker):
    if marker is not None:
        marker.synchronize()


def device_timer(fn, *args, iters: int = 10, pipeline: bool = True):
    """Sustained seconds/iteration of `fn(*args)` with true completion.

    pipeline=True overlaps dispatch i+1 with the wait for i (throughput);
    False serialises (latency). One warm-up call comes first.
    """
    _wait(_mark(fn(*args)))  # warm-up
    if pipeline:
        t0 = time.perf_counter()
        pending = _mark(fn(*args))
        for _ in range(iters - 1):
            nxt = _mark(fn(*args))
            _wait(pending)
            pending = nxt
        _wait(pending)
        return (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        _wait(_mark(fn(*args)))
    return (time.perf_counter() - t0) / iters

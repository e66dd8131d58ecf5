"""Profiling helpers.

The port's counterpart of ``detectorch_tpu/utils/profiling.py``:
  * `trace(logdir)` — context manager around ``torch.profiler`` (with CUDA
    activities when a card is present) that writes a Chrome / Perfetto
    trace file under `logdir`, as ``jax.profiler`` writes its capture there;
  * `device_timer` — sustained seconds per call of a function whose work
    runs asynchronously on a card, waiting for each call's work to finish;
  * `span(name)` — a layer span of the program (a context manager and a
    decorator): while a ``torch.profiler`` records, a ``record_function``
    named ``detectorch::<name>``, in the same Chrome trace as the kernels
    and on their clock; otherwise nothing but the check. So any `trace`
    capture, and any other ``torch.profiler`` around the program, shows the
    layer spans of each request: ``detectorch::request`` around the
    inference forward (``models/detector.make_inference_fn``), and inside it
    ``backbone``, ``proposals`` (RPN mode only), ``box_head``,
    ``postprocess`` and ``mask`` (mask presets only).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

SPAN_PREFIX = "detectorch::"


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


class span:
    """``with span("backbone"): ...`` or ``@span("backbone")``: a
    ``torch.profiler.record_function("detectorch::backbone")`` while a
    profiler records (checked on each entry), else nothing. Spans nest by
    the host thread's stack, so each span's parent is the span around it."""

    __slots__ = ("name", "_record")

    def __init__(self, name: str):
        self.name = name
        self._record = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._record = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self._record.__enter__()
        return self

    def __exit__(self, *exc):
        record, self._record = self._record, None
        if record is not None:
            record.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):  # a span of its own per call
                return fn(*args, **kwargs)

        return spanned


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

"""The benchmark's reader of the port's layer spans
(``benchmark/harness/spans.py``) and the per-layer metrics that read it, on
a small Chrome trace written here.

The trace (microseconds, one host thread): a window 0..1000 holding two
requests, A 10..400 and B 500..900, each with the five layer spans; A's
``proposals`` holds a child span ``nms``. Device events on stream 7, one on
stream 8:

  k1 [40, 90]    launched at 30, in A's backbone
  k2 [150, 190]  launched at 95, in A's backbone: runs after the span ended
  k3 [192, 198]  no launch in the trace: the previous event on stream 7 (k2)
  k4 [200, 240]  launched at 130, in A's nms, inside proposals
  k5 [270, 300]  launched at 260, in A's postprocess
  m1 [410, 420]  a copy launched at 405, outside every span (the fetch)
  k6 [530, 590]  launched at 520, in B's backbone
  s8 [600, 610]  stream 8, no launch and nothing before it: outside
  k7 [820, 860]  launched at 810, in B's mask

Syncs at 170 (nms), 260 and 280 (postprocess), 418 and 950 (outside).
"""

import json

import pytest

from benchmark.harness import spans as spans_mod
from benchmark.harness.trace import Trace
from benchmark.run import ROOT, read_layer_metric

REQUEST_A = [("request", 10, 400), ("backbone", 15, 100), ("proposals", 100, 200),
             ("nms", 115, 180), ("box_head", 200, 250), ("postprocess", 250, 330),
             ("mask", 330, 390)]
REQUEST_B = [("request", 500, 900), ("backbone", 510, 600), ("proposals", 600, 700),
             ("box_head", 700, 750), ("postprocess", 750, 800), ("mask", 800, 880)]
# (name, cat, start, end, correlation, stream, launched at)
DEVICE = [("k1", "kernel", 40, 90, 1, 7, 30), ("k2", "kernel", 150, 190, 2, 7, 95),
          ("k3", "kernel", 192, 198, 99, 7, None), ("k4", "kernel", 200, 240, 3, 7, 130),
          ("k5", "kernel", 270, 300, 4, 7, 260), ("m1", "gpu_memcpy", 410, 420, 5, 7, 405),
          ("k6", "kernel", 530, 590, 6, 7, 520), ("s8", "kernel", 600, 610, 98, 8, None),
          ("k7", "kernel", 820, 860, 7, 7, 810)]
SYNCS = [("cudaStreamSynchronize", t) for t in (170, 260, 280, 418)] + [
    ("cudaDeviceSynchronize", 950)]

# per request (two requests), ms and syncs
BUSY_MS = {"backbone": (50 + 40 + 6 + 60) / 2e3, "proposals": 40 / 2e3, "box_head": 0.0,
           "postprocess": 30 / 2e3, "mask": 40 / 2e3}
# gaps by middle: 20 backbone, 120 nms, 191 and 199 proposals, 255 postprocess,
# 355 mask, 475 outside, 595 backbone, 715 box_head, 930 outside
WAIT_MS = {"backbone": (40 + 10) / 2e3, "proposals": (60 + 2 + 2) / 2e3,
           "box_head": 210 / 2e3, "postprocess": 30 / 2e3, "mask": 110 / 2e3}
SYNCS_PER_REQUEST = {"proposals": 0.5, "postprocess": 1.0}


def _write(path, with_spans=True):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench_window", "pid": 1, "tid": 1,
           "ts": 0.0, "dur": 1000.0, "args": {}}]
    if with_spans:
        ev += [{"ph": "X", "cat": "user_annotation", "name": "detectorch::" + n, "pid": 1,
                "tid": 1, "ts": float(a), "dur": float(b - a), "args": {}}
               for n, a, b in REQUEST_A + REQUEST_B]
    for name, cat, a, b, corr, stream, at in DEVICE:
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream,
                   "ts": float(a), "dur": float(b - a),
                   "args": {"correlation": corr, "stream": stream, "device": 0}})
        if at is not None:
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaMemcpyAsync" if cat == "gpu_memcpy" else "cudaLaunchKernel",
                       "pid": 1, "tid": 1, "ts": float(at), "dur": 2.0,
                       "args": {"correlation": corr}})
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": n, "pid": 1, "tid": 1, "ts": float(t),
            "dur": 1.0, "args": {"correlation": 1000 + t}} for n, t in SYNCS]
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(path), "bench_window")


@pytest.fixture
def trace(tmp_path):
    return _write(tmp_path / "trace.json")


def test_busy_goes_to_the_launch_span(trace):
    s = spans_mod.Spans(trace)
    assert s.requests == 2
    placed = {e["name"]: where for e, where, _ in s.placed}
    assert [e["name"] for e, _, launched in s.placed if not launched] == ["k3", "s8"]
    assert placed == {"k1": "backbone", "k2": "backbone", "k3": "backbone", "k4": "nms",
                      "k5": "postprocess", "m1": None, "k6": "backbone", "s8": None,
                      "k7": "mask"}
    for name, ms in BUSY_MS.items():
        assert s.busy_ms(name) == pytest.approx(ms)
    assert s.busy_ms("nms") == pytest.approx(40 / 2e3)  # also in proposals, its parent
    assert s.busy_ms(spans_mod.OUTSIDE) == pytest.approx(20 / 2e3)
    assert (s.unlaunched, s.unlaunched_s) == (2, pytest.approx(16e-6))
    total = sum(BUSY_MS.values()) + s.busy_ms(spans_mod.OUTSIDE)
    assert total == pytest.approx(trace.busy_s * 1e3 / 2)


def test_wait_goes_to_the_innermost_span(trace):
    s = spans_mod.Spans(trace)
    assert [s.names[i] if i >= 0 else None for _, _, i in s.gaps] == [
        "backbone", "nms", "proposals", "proposals", "postprocess", "mask", None, "backbone",
        "box_head", None]
    for name, ms in WAIT_MS.items():
        assert s.wait_ms(name) == pytest.approx(ms)
    assert s.wait_ms("nms") == pytest.approx(60 / 2e3)
    assert s.wait_ms(spans_mod.OUTSIDE) == pytest.approx((110 + 140) / 2e3)
    idle_ms = (trace.window_s - trace.busy_s) * 1e3 / 2
    assert s.wait_ms("request") + s.wait_ms(spans_mod.OUTSIDE) == pytest.approx(idle_ms)
    assert sum(WAIT_MS.values()) == pytest.approx(s.wait_ms("request"))


def test_syncs_by_span(trace):
    s = spans_mod.Spans(trace)
    for name, n in SYNCS_PER_REQUEST.items():
        assert s.syncs_per_request(name) == n
    assert s.syncs_per_request(spans_mod.OUTSIDE) == 1.0
    assert s.syncs_per_request("backbone") == 0.0
    assert sum(s.syncs[k] for k in ("request", spans_mod.OUTSIDE)) == trace.syncs


def _new_metrics():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    layers = ("backbone", "proposals", "box_head", "postprocess", "mask")
    return [m["name"] for m in spec["per_layer"] if m["name"].split(".")[0].endswith(
        tuple(f"{n}_{k}" for n in layers for k in ("busy_ms", "wait_ms", "syncs")))]


def test_the_metrics_read_per_request(trace):
    # each of the twelve metrics reads its span's number over the request spans
    names = _new_metrics()
    assert len(names) == 12
    want = {**{f"{k}_busy_ms.infer": v for k, v in BUSY_MS.items()},
            **{f"{k}_wait_ms.infer": v for k, v in WAIT_MS.items()},
            **{f"{k}_syncs.infer": v for k, v in SYNCS_PER_REQUEST.items()}}
    assert sorted(names) == sorted(want)
    for name in names:
        assert read_layer_metric(name, {"trace": trace}) == pytest.approx(want[name]), name


def test_no_spans_reads_nothing(tmp_path):
    # a program without spans: every metric reads nothing, and nothing raises
    trace = _write(tmp_path / "trace.json", with_spans=False)
    assert spans_mod.Spans(trace).requests == 0
    for name in _new_metrics():
        assert read_layer_metric(name, {"trace": trace}) is None, name

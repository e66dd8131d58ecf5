"""The port's layer spans (``utils/profiling.span``) in the inference
request, under a CPU ``torch.profiler`` and without one.

The small presets of tests/test_torch_detector.py and
tests/test_torch_c4_detector.py: fp32, RPN 200 -> 16 proposals, 8
detections, a batch of two 64x96 images, ``init_params(seed=123)``; Fast
R-CNN mode is the FPN mask preset with ``use_rpn=False`` and 24 given
proposals an image.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
from detectorch_tpu_torch.config import PRESETS, RPNConfig
from detectorch_tpu_torch.config import TestConfig as PortTestConfig
from detectorch_tpu_torch.models import detector as tdet
from detectorch_tpu_torch.utils import profiling

LAYERS = ("backbone", "proposals", "box_head", "postprocess", "mask")
CASES = {
    "fpn_mask": ("e2e_mask_rcnn_R-50-FPN_2x", True),
    "c4_mask": ("e2e_mask_rcnn_R-50-C4_2x", True),
    "fast_rcnn_fpn_mask": ("e2e_mask_rcnn_R-50-FPN_2x", False),
}
REQUESTS = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(expected layer spans, the request's fn, its arguments, params)."""
    preset, rpn = CASES[request.param]
    cfg = PRESETS[preset].replace(compute_dtype="float32", use_rpn=rpn,
                                  rpn=RPNConfig(pre_nms_top_n=200, post_nms_top_n=16))
    params = params_to_device(params_from_jax(tdet.init_params(cfg, seed=123)), "cpu")
    rng = np.random.RandomState(5)
    args = [torch.from_numpy((rng.randn(2, 64, 96, 3) * 4).astype(np.float32)),
            torch.tensor([1.2, 1.1]), torch.tensor([50.0, 55.0]), torch.tensor([80.0, 85.0])]
    if not rpn:
        x1, y1 = rng.uniform(0, 80, (2, 24)), rng.uniform(0, 50, (2, 24))
        args.append(torch.from_numpy(np.stack(
            [x1, y1, x1 + rng.uniform(4, 90, (2, 24)), y1 + rng.uniform(4, 60, (2, 24))],
            -1).astype(np.float32)))
    layers = [n for n in LAYERS if rpn or n != "proposals"]
    fn = tdet.make_inference_fn(cfg, PortTestConfig(detections_per_img=8, score_thresh=0.0))
    return layers, fn, args, params


def _flat(out):
    return [t for t in (*out, *out.detections) if isinstance(t, torch.Tensor)]


def _profiled(fn, path):
    """fn() under a CPU torch.profiler -> (its result, the trace's
    detectorch:: spans as (name, start, end), by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"][len(profiling.SPAN_PREFIX):], float(e["ts"]),
              float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e["name"].startswith(profiling.SPAN_PREFIX)]
    return result, sorted(spans, key=lambda s: (s[1], -s[2]))


def test_request_spans_nest_in_order(case, tmp_path):
    # each request: one request span, its layer spans inside it, in order,
    # without overlap; the outputs bitwise those of a call with no profiler
    layers, fn, args, params = case
    plain = [_flat(fn(params, *args)) for _ in range(REQUESTS)]
    traced, spans = _profiled(lambda: [_flat(fn(params, *args)) for _ in range(REQUESTS)],
                              tmp_path / "trace.json")
    requests = [s for s in spans if s[0] == "request"]
    assert len(requests) == REQUESTS
    for _, a, b in requests:
        inner = [s for s in spans if s[0] != "request" and a <= s[1] <= b]
        assert [s[0] for s in inner] == layers
        assert all(a <= s1 <= s2 <= b for _, s1, s2 in inner)
        assert all(x[2] <= y[1] for x, y in zip(inner, inner[1:]))
    assert len(spans) == REQUESTS * (1 + len(layers))
    for p, t in zip(plain, traced):
        assert len(p) == len(t)
        for x, y in zip(p, t):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_no_profiler_enters_no_record_function(case, monkeypatch, tmp_path):
    layers, fn, args, params = case
    entered = []
    real = torch.profiler.record_function

    class counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    fn(params, *args)
    assert entered == []
    _profiled(lambda: fn(params, *args), tmp_path / "trace.json")
    assert [n[len(profiling.SPAN_PREFIX):] for n in entered] == ["request", *layers]


@pytest.mark.parametrize("defined_under_profiler", [False, True])
def test_span_decorator_decides_per_call(defined_under_profiler, tmp_path):
    # whether a profiler records is read on each call, not when decorating
    def define():
        @profiling.span("outer")
        def f(x):
            with profiling.span("inner"):
                return x + 1
        return f

    if defined_under_profiler:
        with profile(activities=[ProfilerActivity.CPU]):
            f = define()
    else:
        f = define()
    assert f.__name__ == "f"
    assert int(f(torch.tensor(1))) == 2
    out, spans = _profiled(lambda: [f(torch.tensor(k)) for k in range(3)], tmp_path / "t.json")
    assert [int(o) for o in out] == [1, 2, 3]
    assert [s[0] for s in spans] == ["outer", "inner"] * 3

"""The ResNeXt cell's runner and counts (``benchmark/harness/infer_resnext``,
``benchmark/harness/grouped``) and its two metrics, cheaply: the runner's
pointing at the ResNeXt reference undone after it, the grouped FLOP and
byte count of one layer, the request's closed form, and the metrics on a
small Chrome trace written here."""

import json

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run
from benchmark.harness import check, flops, grouped, infer, infer_resnext, program, weights
from benchmark.harness.flops import Layers
from benchmark.harness.trace import Trace
from benchmark.reference import model as M
from benchmark.reference import resnext as R
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.models import resnet
from detectorch_tpu_torch.models.detector import init_params

# res3's first grouped conv at batch 1 on a 64x96 res2 map: 512 channels in
# 64 groups of 8, stride 2
LAYER = (1, 64, 96, 512, 512, 3, 2, 1, 64)


def _cfg(cell):
    return run.load_cell(cell)[3]


@pytest.mark.parametrize("raises", [False, True])
def test_runner_points_back_at_resnet50(monkeypatch, raises):
    """While the runner runs, the blobs, the check and the FLOP count are the
    ResNeXt trunk's; after it, also where the run raises, they are
    ResNet-50's again for the flagship's cell."""
    x101, fpn = _cfg("x101_mask.infer_b8"), _cfg("fpn_mask.infer_b8")
    seen = {}

    def fake_run(cell, cfg, mix, *args, **kwargs):
        seen.update(M=check.M, spec=weights.blob_spec(cfg),
                    flops=flops.request_layer_flops(cfg, 8, 832, 1344))
        if raises:
            raise KeyError("no such preset")
        return {"layer": None}

    monkeypatch.setattr(infer, "run", fake_run)
    if raises:
        with pytest.raises(KeyError):
            infer_resnext.run({}, x101, {"batch": 8}, 1, 1.0, False, "cpu", 0.0)
    else:
        infer_resnext.run({}, x101, {"batch": 8}, 1, 1.0, False, "cpu", 0.0)
    assert seen["M"] is R and seen["spec"] == R.blob_spec(x101)
    assert round(seen["flops"] / 8e9, 2) == 1069.31
    assert check.M is M and weights.blob_spec is M.blob_spec and flops.Layers is Layers
    assert weights.blob_spec(fpn) == M.blob_spec(fpn)
    assert round(flops.request_layer_flops(fpn, 8, 832, 1344) / 8e9, 2) == 552.18


def test_one_grouped_layer():
    """The grouped count of one conv equals FlopCounterMode's count of
    ``F.conv2d(..., groups=64)``, 64 times under the dense count; its
    bytes are the bf16 map in, the weights and the map out."""
    b, h, w, cin, cout, k, s, p, g = LAYER
    x, wt = torch.zeros(b, cin, h, w), torch.zeros(cout, cin // g, k, k)
    with FlopCounterMode(display=False) as fc:
        F.conv2d(x, wt, stride=s, padding=p, groups=g)
    assert grouped.conv_flops(*LAYER) == fc.get_total_flops() == 2 * 32 * 48 * 9 * 8 * 512
    assert grouped.conv_flops(*LAYER[:-1], 1) == 64 * grouped.conv_flops(*LAYER)
    assert grouped.conv_bytes(*LAYER) == 2 * (64 * 96 * 512 + 512 * 8 * 9 + 32 * 48 * 512)
    bound = max(grouped.conv_flops(*LAYER) / 989e12, grouped.conv_bytes(*LAYER) / 3.35e12)
    assert grouped.least_ms(LAYER) == pytest.approx(bound * 1e3)


def test_trunk_calls_at_the_cells_size():
    """33 grouped convs a request, 0.34 TFLOP and 7.1 GB a batch of 8 at
    832x1344; the stride on the 3x3, so the 1x1 before it at full size."""
    cfg = _cfg("x101_mask.infer_b8")
    calls = grouped.trunk_calls(cfg, 8, 832, 1344)
    assert len(calls) == 33 and [c[6] for c in calls].count(2) == 3
    assert round(sum(grouped.conv_flops(*c) for c in calls) / 1e12, 3) == 0.340
    assert round(sum(grouped.conv_bytes(*c) for c in calls) / 1e9, 2) == 7.13
    L = grouped.GroupedLayers(cfg["trunk"])
    L.stage(8, 208, 336, 256, 1, 2)  # res3: stride on the 3x3, the 1x1 at full size
    assert [c[1:3] for c in L.grouped] == [(208, 336)] + [(104, 168)] * 3


def _trace(path, with_spans=True):
    """Two requests, each with a backbone holding two grouped_conv spans;
    a kernel of 30 us launched in each grouped_conv span, one of 50 us in
    each backbone outside them."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench_window", "ts": 0.0,
           "dur": 1000.0, "tid": 1}]
    corr = 0
    for r in (0, 500):
        spans = [("request", r + 10, r + 400), ("backbone", r + 20, r + 300),
                 ("grouped_conv", r + 50, r + 60), ("grouped_conv", r + 100, r + 110)]
        ev += [{"ph": "X", "cat": "user_annotation", "name": "detectorch::" + n, "tid": 1,
                "ts": float(a), "dur": float(b - a)} for n, a, b in spans if with_spans]
        for at, dur in ((r + 55, 30), (r + 105, 30), (r + 200, 50)):
            corr += 1
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1,
                       "ts": float(at), "dur": 2.0, "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "tid": 7,
                       "ts": float(at + 5), "dur": float(dur),
                       "args": {"correlation": corr, "stream": 7}})
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(path), "bench_window")


@pytest.mark.parametrize("with_spans", [True, False])
def test_grouped_conv_metrics(tmp_path, with_spans):
    layer = {"trace": _trace(tmp_path / "trace.json", with_spans),
             "grouped_conv": {"bound_ms": 0.015}}
    busy = run.read_layer_metric("grouped_conv_busy_ms.infer", layer)
    share = run.read_layer_metric("grouped_conv_roofline.infer", layer)
    if with_spans:
        assert busy == pytest.approx(0.06) and share == pytest.approx(25.0)
    else:
        assert busy is None and share is None
    # a runner that counted no bounds (any other cell's) reads no share
    del layer["grouped_conv"]
    assert run.read_layer_metric("grouped_conv_roofline.infer", layer) is None


def test_the_resnext_spec_is_the_ports_skeleton_at_one_block_a_stage(monkeypatch):
    """Every blob of the reference's spec is one the port's importer wants,
    at the same shape, and none is missing: grouped branch2b, the FPN named
    after each stage's last block."""
    cfg = _cfg("x101_mask.infer_b8")
    cfg["trunk"]["blocks"] = [1, 1, 1, 1]
    monkeypatch.setitem(resnet.STAGE_BLOCKS, "resnext101_64x4d", (1, 1, 1, 1))
    model_cfg, _ = program.port_configs(cfg)
    skeleton = params_from_jax(init_params(model_cfg))
    spec = R.blob_spec(cfg)
    assert set(spec) == set(skeleton)
    assert all(tuple(skeleton[k].shape) == v for k, v in spec.items())
    assert spec["res5_0_branch2b_w"] == (2048, 32, 3, 3)
    assert "fpn_inner_res4_0_sum_lateral_w" in spec

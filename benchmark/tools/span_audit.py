"""The port's layer spans in a traced run of a cell, held against the traced
window's own totals, and what one span costs.

    python3 benchmark/tools/span_audit.py --workload <cell> --seed <n> --seconds <s>

Runs the cell as ``benchmark/run.py --trace 1`` does and prints one JSON
line: `correct`, every per-layer metric, and per request of the traced
window: its busy, idle and sync totals; each span name's busy, wait and
syncs (``harness/spans``; "outside" is no span: the harness's fetch and
loop); the identities the spans should keep (the five layers' busy plus
the rest against the window's busy, their wait plus the rest against its
idle, their syncs plus the rest against ``host_syncs.infer``); the device
events placed by the previous-event rule (by name and by span, and how
many lie between launched events of two spans); the forward RoIAlign
kernels' ms by span; the device ops outside every span; the longest idle
gaps in no layer span, with the host events under way in each. Last,
one span's
enter and exit in µs with no profiler and under ``torch.profiler`` (CPU and
CUDA activities), the least of 3 loops of `--span-calls`.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
LAYERS = ("backbone", "proposals", "box_head", "postprocess", "mask")


def audit(trace, metrics) -> dict:
    """The span tables of `trace` per request, and the identities."""
    from benchmark.harness import spans

    s = spans.of(trace)
    n = s.requests
    if not n:
        return {"requests": 0}

    def table(t, scale):
        return {(k or "outside"): v * scale / n for k, v in sorted(t.items())}

    busy_ms = trace.busy_s * 1e3 / n
    idle_ms = (trace.window_s - trace.busy_s) * 1e3 / n
    layers_busy = sum(s.busy_ms(k) for k in LAYERS)
    layers_wait = sum(s.wait_ms(k) for k in LAYERS)
    out_busy, out_wait = s.busy_ms(spans.OUTSIDE), s.wait_ms(spans.OUTSIDE)
    roi = defaultdict(float)
    unlaunched = defaultdict(lambda: [0, 0.0])
    unlaunched_span = defaultdict(float)
    outside = defaultdict(float)
    for e, where, launched in s.placed:
        ms = float(e["dur"]) * 1e-3 / n
        if "roi_align_fwd" in e["name"]:
            roi[where or "outside"] += ms
        if not launched:
            unlaunched[e["name"][:64]][0] += 1
            unlaunched[e["name"][:64]][1] += ms
            unlaunched_span[where or "outside"] += ms
        if where is None:
            outside[f"{e.get('cat')}:{e['name'][:48]}"] += ms
    # an unlaunched event between launched ones of two spans on its stream
    # may belong to either: the rule's only doubt
    doubt = 0
    streams = defaultdict(list)
    for e, where, launched in s.placed:
        streams[e.get("args", {}).get("stream")].append((where, launched))
    for events in streams.values():
        for k, (where, launched) in enumerate(events):
            if not launched:
                nxt = next((w for w, ok in events[k + 1:] if ok), where)
                doubt += nxt != where
    # the idle gaps in no layer span: ms from the window's start, ms, span,
    # and the host events under way in the gap (ms into the gap, ms, name):
    # how many, those open at its middle, the longest
    gaps = []
    for a, b, i in s.gaps:
        name = s.names[i] if i >= 0 else "outside"
        if name not in LAYERS:
            mid = (a + b) / 2
            host = [[(float(e["ts"]) - a) * 1e-3, float(e["dur"]) * 1e-3, e["name"][:40]]
                    for e in trace.host
                    if float(e["ts"]) < b and float(e["ts"]) + float(e["dur"]) > a]
            stack = sorted(h for h in host if h[0] * 1e3 + a <= mid <= (h[0] + h[1]) * 1e3 + a)
            longest = sorted(host, key=lambda h: -h[1])[:6]
            gaps.append([(a - trace.t0) * 1e-3, (b - a) * 1e-3, name,
                         {"events": len(host), "at_middle": stack, "longest": longest}])
    return {
        "requests": n, "window_ms": trace.window_s * 1e3 / n, "busy_ms": busy_ms,
        "idle_ms": idle_ms, "host_syncs": trace.syncs / n,
        "busy_ms_by_span": table(s.busy_s, 1e3), "wait_ms_by_span": table(s.wait_s, 1e3),
        "syncs_by_span": table(s.syncs, 1.0), "spans_per_request": len(s.names) / n,
        "busy": {"layers": layers_busy, "request_not_layers": s.busy_ms("request") - layers_busy,
                 "outside": out_busy,
                 "layers_vs_busy_less_outside": layers_busy / (busy_ms - out_busy) - 1},
        "wait": {"layers": layers_wait, "request_not_layers": s.wait_ms("request") - layers_wait,
                 "outside": out_wait,
                 "layers_and_outside_vs_idle": (layers_wait + out_wait) / idle_ms - 1},
        "syncs": {"proposals_and_postprocess": sum(s.syncs_per_request(k)
                                                   for k in ("proposals", "postprocess")),
                  "host_syncs_less_one": trace.syncs / n - 1},
        "unlaunched": {"events": s.unlaunched, "ms": s.unlaunched_s * 1e3 / n,
                       "ms_by_span": dict(unlaunched_span), "between_two_spans": doubt,
                       "by_name": sorted(([k, c, ms] for k, (c, ms) in unlaunched.items()),
                                         key=lambda x: -x[2])[:12]},
        "gaps_in_no_layer": sorted(gaps, key=lambda g: -g[1])[:12],
        "roi_align_fwd_ms_by_span": dict(roi),
        "outside_ops_ms": sorted(([k, v] for k, v in outside.items()), key=lambda x: -x[1]),
        "metrics": metrics,
    }


def span_cost_us(calls: int, device) -> dict:
    """µs of one ``with span(...)`` entered and left: no profiler, then
    under torch.profiler; the least of 3 loops each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from detectorch_tpu_torch.utils.profiling import span

    def loop():
        t0 = time.perf_counter()
        for _ in range(calls):
            with span("backbone"):
                pass
        return (time.perf_counter() - t0) / calls * 1e6

    off = min(loop() for _ in range(3))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts):
        on = min(loop() for _ in range(3))
    return {"no_profiler_us": off, "profiler_us": on, "calls": calls}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--span-calls", type=int, default=5000)
    args = p.parse_args(argv)
    from benchmark import run

    spec, w, cell, cfg, mix = run.load_cell(args.workload)
    device = run.device_check(w["chips"])
    runner = importlib.import_module(f"benchmark.harness.{cell['kind']}")
    r = runner.run(cell, cfg, mix, args.seed, args.seconds, True, device, run.T_START)
    _, layer = run.cell_metrics(spec, args.workload)
    metrics = {m["name"]: run.read_layer_metric(m["name"], r["layer"]) for m in layer}
    line = {"workload": args.workload, "seed": args.seed, "correct": r["checks"][0],
            "e2e": r["e2e"], **audit(r["trace"], metrics),
            "span_cost": span_cost_us(args.span_calls, device)}
    line["span_cost"]["request_share"] = (line["span_cost"]["profiler_us"]
                                          * line.get("spans_per_request", 0)
                                          / (line.get("window_ms", 1) * 1e3))
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()

"""The benchmark of the PyTorch port, ``detectorch_tpu_torch``, on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything comes from data: the cell (``BENCHMARK.json``'s ``workloads``)
names its configuration (``benchmark/configs/<config>.json``) and traffic
mix (``benchmark/traffic/<mix>.json``); ``benchmark/cells/<cell>.json``
holds its run settings and the limits of its check, and names the module
that runs it (``benchmark/harness/<kind>.py``); each per-layer metric is read by
``benchmark/metrics/<metric>.py``. Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error). Exits non-zero, printing no result, without enough CUDA
devices, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "detectorch_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_cell(name: str):
    """(BENCHMARK.json, its workload entry, cell settings, config, mix)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    cell = json.loads((BENCH / "cells" / f"{name}.json").read_text())
    return spec, w, cell, cfg, mix


def cell_metrics(spec: dict, name: str):
    """(end-to-end metrics, per-layer metrics) that the cell reports."""
    def ours(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in spec["end_to_end"] if ours(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if ((name in m["workloads"]) if "workloads" in m else (m["moves"] in moved))]
    return e2e, layer


def read_layer_metric(name: str, layer: dict):
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(layer)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_check(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA device(s), "
                         f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None, fault=None,
             adjust=None, t_start: float = T_START) -> dict:
    """One run of a cell -> the result object (without printing it).
    `device` None looks for the card. For the tests: `fault` breaks the
    timed path, `adjust(cell, cfg, mix)` shrinks the sizes."""
    spec, w, cell, cfg, mix = load_cell(name)
    if adjust is not None:
        adjust(cell, cfg, mix)
    if device is None:
        device = device_check(w["chips"])
    import torch

    runner = importlib.import_module(f"benchmark.harness.{cell['kind']}")
    r = runner.run(cell, cfg, mix, seed, seconds, trace, device, t_start, fault=fault)
    e2e, layer = cell_metrics(spec, name)
    if trace:
        metrics = {}
        for m in layer:
            v = read_layer_metric(m["name"], r["layer"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": r["e2e"][m["name"]], "unit": m["unit"]} for m in e2e}
    dev = torch.device(device)
    device_line = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": r["memory_peak_bytes"]}
    correct, checks = r["checks"]
    line = {"correct": correct, "attempted": r["attempted"], "failed": r["failed"],
            "metrics": metrics, "device": device_line}
    if trace:
        tr = r["trace"]
        device_line["busy_s"] = tr.busy_s
        device_line["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = checks
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"refusing to report: loaded {bad}")
        sys.exit(3)
    for k, v in line["checks"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()

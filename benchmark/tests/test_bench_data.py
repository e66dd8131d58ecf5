"""The harness finds every cell, configuration, traffic mix and per-layer
metric by name from its files, and BENCHMARK.json keeps the contract's
shape."""

import json
import re
from pathlib import Path

import pytest

from benchmark import run
from benchmark.harness import check, traffic

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(cell):
    spec, w, settings, cfg, mix = run.load_cell(cell)
    assert cfg["name"] == w["config"]
    assert (ROOT / "benchmark" / "harness" / f"{settings['kind']}.py").is_file()
    assert set(settings) == {"kind", "roi_pre_margin", "limits"}
    assert set(settings["limits"]) == set(check.NUMBERS)
    assert all(v is not None for v in settings["limits"].values())
    e2e, layer = run.cell_metrics(spec, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    assert traffic.load(w["traffic"]) == mix


def test_names_units_and_entries():
    seen = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])


def test_every_metric_file_is_named_in_the_benchmark():
    named = {m["name"] for m in SPEC["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "benchmark" / "metrics").glob("*.py")}
    assert files == named

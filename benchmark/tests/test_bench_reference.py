"""The reference (plain PyTorch, fp32) agrees with the port in fp32 at a
small size on the CPU, for both configurations, on the benchmark's seeded
Detectron-format weights loaded through the port's importer."""

import pytest
import torch

from benchmark import run
from benchmark.harness import check, program
from benchmark.harness.traffic import make_pool
from benchmark.harness.weights import make_blobs
from benchmark.reference import model as M
from benchmark.tests.small import CELLS, SEED, shrink
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.models.detector import init_params


@pytest.mark.parametrize("cell", CELLS)
def test_blobs_are_the_ports_skeleton(cell):
    """Every blob the benchmark makes is one the port's importer wants, at
    the same shape, and none is missing."""
    _, _, _, cfg, _ = run.load_cell(cell)
    model_cfg, _ = program.port_configs(cfg)
    skeleton = params_from_jax(init_params(model_cfg))
    spec = M.blob_spec(cfg)
    assert set(spec) == set(skeleton)
    assert all(tuple(skeleton[k].shape) == v for k, v in spec.items())


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_port_fp32(cell):
    _, _, settings, cfg, mix = run.load_cell(cell)
    shrink(settings, cfg, mix)
    cfg["model"]["compute_dtype"] = "float32"
    blobs = make_blobs(cfg, SEED, "cpu")
    model_cfg, test_cfg = program.port_configs(cfg)
    params = program.load_params(blobs, model_cfg, "cpu")
    batch = make_pool(mix, SEED, "cpu")[0]
    out = program.inference_fn(model_cfg, test_cfg, "cpu")(params, *batch)
    d = out.detections
    answers = program.per_image(out, (d.boxes, d.scores, d.classes, d.valid, out.masks))
    assert all(int(a["roi_valid"].sum()) == 300 for a in answers)
    assert all(int(a["det_valid"].sum()) == 100 for a in answers)
    n = check.judge(cfg, settings["roi_pre_margin"], blobs, [(batch, answers)])
    assert n["roi_unmatched"] == 0
    assert all(n[k] < 1e-4 for k in ("cls_gap", "det_score_gap", "det_select_gap", "mask_gap"))


def test_weights_follow_the_seed():
    _, _, _, cfg, mix = run.load_cell(CELLS[0])
    a, b = make_blobs(cfg, SEED, "cpu"), make_blobs(cfg, SEED, "cpu")
    c = make_blobs(cfg, SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc6_w"], c["fc6_w"])

"""The ResNeXt cell's check decides ``correct`` as it must: a sound run of
``x101_mask.infer_b8`` reads true; the float8 control in the program's
place, and runs with the trunk broken underneath (``faults_resnext``: the
stride on the 1x1 instead of the grouped 3x3, each group reading the next
group's channels), read false. At the benchmark's small size on the CPU
with the cell's own limits; the control at the cell's own size runs on the
card."""

import pytest

from benchmark import run
from benchmark.harness import check
from benchmark.harness.infer_resnext import pointed_at_resnext
from benchmark.harness.traffic import make_pool
from benchmark.harness.weights import make_blobs
from benchmark.tests.faults_resnext import FAULTS
from benchmark.tests.small import SEED, shrink

CELL = "x101_mask.infer_b8"


def test_sound_run_is_correct(small_run):
    line = run.run_cell(CELL, SEED, 0.1, False, device="cpu", adjust=shrink)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"infer_img_per_s", "infer_request_ms_p95", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_trunk_is_not_correct(small_run, fault):
    line = run.run_cell(CELL, SEED, 0.1, False, device="cpu", fault=FAULTS[fault],
                        adjust=shrink)
    assert line["correct"] is False, line["checks"]


def _control_passes(settings, cfg, mix, seed, device):
    with pointed_at_resnext(cfg):
        blobs = make_blobs(cfg, seed, device)
        batch = make_pool(mix, seed, device)[0]
        numbers = check.judge(cfg, settings["roi_pre_margin"], blobs,
                              [(batch, check.control_answers(cfg, blobs, batch))])
    return check.verdict(numbers, settings["limits"])[0], numbers


def test_control_fails_small():
    _, _, settings, cfg, mix = run.load_cell(CELL)
    shrink(settings, cfg, mix)
    ok, numbers = _control_passes(settings, cfg, mix, SEED, "cpu")
    assert not ok, numbers


@pytest.mark.card
def test_control_fails_at_the_cells_size(card):
    _, _, settings, cfg, mix = run.load_cell(CELL)
    for k in range(3):
        ok, numbers = _control_passes(settings, cfg, mix, SEED + k, card)
        assert not ok, numbers

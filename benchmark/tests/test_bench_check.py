"""The check that decides ``correct`` fails where it must: the float8
control in the program's place, and a run driven through the harness with
the timed path broken underneath (``faults.FAULTS``: an answer altered
where the program produces it, half of a batch's proposals left out, the
cap keeping the wrong detections). At a small size on the CPU, with the
cells' own limits; the control at the cells' own size runs on the card."""

import pytest

from benchmark import run
from benchmark.harness import check
from benchmark.harness.traffic import make_pool
from benchmark.harness.weights import make_blobs
from benchmark.tests.faults import FAULTS
from benchmark.tests.small import CELLS, SEED, shrink


def _cell(name):
    _, _, settings, cfg, mix = run.load_cell(name)
    shrink(settings, cfg, mix)
    return settings, cfg, mix


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_small(cell):
    settings, cfg, mix = _cell(cell)
    blobs = make_blobs(cfg, SEED, "cpu")
    batch = make_pool(mix, SEED, "cpu")[0]
    numbers = check.judge(cfg, settings["roi_pre_margin"], blobs,
                          [(batch, check.control_answers(cfg, blobs, batch))])
    ok, _ = check.verdict(numbers, settings["limits"])
    assert not ok, numbers


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    _, _, settings, cfg, mix = run.load_cell(cell)
    for k in range(3):
        blobs = make_blobs(cfg, SEED + k, card)
        batch = make_pool(mix, SEED + k, card)[0]
        numbers = check.judge(cfg, settings["roi_pre_margin"], blobs,
                              [(batch, check.control_answers(cfg, blobs, batch))])
        assert not check.verdict(numbers, settings["limits"])[0], numbers


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(small_run, fault, cell):
    line = run.run_cell(cell, SEED, 0.1, False, device="cpu", fault=FAULTS[fault],
                        adjust=shrink)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_run, cell):
    line = run.run_cell(cell, SEED, 0.1, False, device="cpu", adjust=shrink)
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"infer_img_per_s", "infer_request_ms_p95", "setup_s"}

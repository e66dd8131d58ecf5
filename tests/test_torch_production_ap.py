"""``tools/production_ap`` on the CPU: the ladder's rows, the CLI's row 1
over a 2-image synthetic set (with the multi-scale rows), and its refusal
of the card rows where there is no card. The card rows themselves run in
``chip_smoke.py`` phase 27."""

import json
import math

import pytest
import torch

from detectorch_tpu_torch.tools import probe_weights, production_ap


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ladder_is_cumulative():
    cfg, tcfg = probe_weights.harness_cfg("e2e_mask_rcnn_R-50-FPN_2x")
    rows = production_ap.ladder(cfg, tcfg)
    assert [r.label for r in rows] == [
        "fp32/plain (baseline)", "fp32/kernel", "bf16/kernel", "bf16/kernel/buckets",
        "bf16/kernel/buckets/devpre", "production batched (bf16 masks)"]
    assert [r.on_card for r in rows] == [False] + [True] * 5
    assert [r.tf32_off for r in rows] == [True, True, False, False, False, False]
    assert [r.cfg.compute_dtype for r in rows] == ["float32"] * 2 + ["bfloat16"] * 4
    assert [r.tcfg.exact_blob_dims for r in rows] == [True] * 3 + [False] * 3
    assert [r.tcfg.device_preprocess for r in rows] == [False] * 4 + [True] * 2
    assert [r.batch for r in rows] == [1] * 5 + [production_ap.PRODUCTION_BATCH]
    assert rows[-1].tcfg.mask_fetch_dtype == "bfloat16"
    assert all(r.cfg.roi_align_fwd_precision == "exact" for r in rows)


def test_cli_on_the_cpu_prints_row_1(tmp_path, capsys):
    rows = production_ap.main(["--device", "cpu", "--images", "2", "--root", str(tmp_path),
                               "--presets", "e2e_mask_rcnn_R-50-FPN_2x", "--multiscale"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert lines == rows and len(rows) == 4
    row = rows[0]
    assert (row["preset"], row["row"], row["variant"], row["device"]) == (
        "e2e_mask_rcnn_R-50-FPN_2x", 1, "fp32/plain (baseline)", "cpu")
    assert (row["images"], row["requests"], row["batch"]) == (2, 2, 1)
    assert row["launches"] == {"roi_align_fwd": 0, "roi_align_bwd": 0}
    assert sorted(row["stats"]) == ["bbox", "segm"]
    assert all(len(v) == 12 and all(map(math.isfinite, v)) for v in row["stats"].values())
    assert row["bbox_ap"] == row["stats"]["bbox"][0] > 0.05
    assert (tmp_path / "synth_2" / "torch_weights_r50_fpn_harness.pkl").exists()
    multi = rows[1:]
    assert [r["target_sizes"] for r in multi] == [[256], [192, 256], [192, 256, 320]]
    assert multi[0]["stats"] == row["stats"]  # the single-scale row is row 1 again
    assert all(r["device"] == "cpu" and "max_delta_vs_row1" in r for r in multi[1:])


def test_card_rows_refused_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runs on the card"):
        production_ap.main(["--root", str(tmp_path)])
    with pytest.raises(ValueError, match="RoIAlign kernels on the card"):
        production_ap.main(["--device", "cpu", "--variants", "bf16", "--root", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # refused before any data was made

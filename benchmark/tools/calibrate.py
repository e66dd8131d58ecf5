"""Readings that the limits of the inference cells' checks are set from.

    python3 benchmark/tools/calibrate.py --cell fpn_mask.infer_b8 --seeds 12 --control 3 \
        --faults keep_the_lowest_survivors

For each seed: the cell's weights and pool, the program's answers to the
first ``infer.SAMPLE_REQUESTS`` batches of the pool through the timed
entry, judged by the reference (the lower readings); for the first
``--control`` seeds the control too: the reference in float8 put in the
program's place, judged the same way (the upper readings), and each
named fault planted in the program (``benchmark/tests/faults.py``).
One JSON line per reading, with ``roi_unmatched`` at other IoUs beside
the numbers; on the card only, at the cell's own sizes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ROI_IOUS = (0.5, 0.8, 0.9)  # roi_unmatched at these IoUs too


def report(cell, seed, side, cfg, pre_margin, blobs, samples, t0):
    from benchmark.harness import check

    rows = check.judge_rows(cfg, pre_margin, blobs, samples, ROI_IOUS)
    line = {"cell": cell, "seed": seed, "side": side, **check.combine(rows)}
    for v in ROI_IOUS:
        line[f"roi_unmatched@{v}"] = check.roi_unmatched(rows, v)
    line["seconds"] = time.perf_counter() - t0
    print(json.dumps(line), flush=True)


def answers(fn, params, pool):
    from benchmark.harness import program

    samples = []
    for b in pool:
        out = fn(params, *b)
        d = out.detections
        host = [t.cpu() for t in (d.boxes, d.scores, d.classes, d.valid, out.masks)]
        samples.append((b, program.per_image(out, host)))
    return samples


def main(argv=None):
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import run
    from benchmark.harness import check, infer, program
    from benchmark.harness.traffic import make_pool
    from benchmark.harness.weights import make_blobs
    from benchmark.tests.faults import FAULTS

    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 7)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", default="", help="comma-separated names of faults.FAULTS")
    args = p.parse_args(argv)
    spec, w, cell, cfg, mix = run.load_cell(args.cell)
    device = run.device_check(w["chips"])
    model_cfg, test_cfg = program.port_configs(cfg)
    fn = program.inference_fn(model_cfg, test_cfg, device)
    margin = cell["roi_pre_margin"]
    for n in range(args.seeds):
        seed = args.first_seed + 7919 * n
        t0 = time.perf_counter()
        blobs = make_blobs(cfg, seed, device)
        params = program.load_params(blobs, model_cfg, device)
        pool = make_pool(mix, seed, device)[:infer.SAMPLE_REQUESTS]
        samples = answers(fn, params, pool)
        report(args.cell, seed, "program", cfg, margin, blobs, samples, t0)
        for name in args.faults.split(",") if args.faults and n < args.control else ():
            t0 = time.perf_counter()
            broken = FAULTS[name](fn, model_cfg, test_cfg)
            report(args.cell, seed, f"fault_{name}", cfg, margin, blobs,
                   answers(broken, params, pool), t0)
        del params
        if n < args.control:
            t0 = time.perf_counter()
            ctl = [(b, check.control_answers(cfg, blobs, b)) for b in pool]
            report(args.cell, seed, "control_float8", cfg, margin, blobs, ctl, t0)
        del blobs, pool, samples
        if device.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

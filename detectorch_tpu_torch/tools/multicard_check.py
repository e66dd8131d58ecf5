"""The parallel paths on every card of one machine: the multi-rank dry run
(``parallel.dryrun``) on all cards, then the e2e Mask R-CNN trainer
(``tools/train_fast --fpn --e2e --masks``) under ``torch.distributed.run``
at world N and at world 1 on one synthetic COCO set (``data/synth``) with
the same global batch: each iteration's time and losses.

  python -m detectorch_tpu_torch.tools.multicard_check

Each trainer runs ITERS iterations at the global batch BATCH on IMAGES
synthetic 480x640 images.

Needs at least two CUDA cards. Prints nvidia-smi's name and power limit,
the dry run's line per rank, each trainer iteration, and one JSON summary
line last; exits non-zero if a rank or a check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ITERS = 6
BATCH = 8  # the global batch
IMAGES = 16


def iteration_times(stats):
    """Each iteration's seconds from the trainer's json_stats, whose
    'time' is the running mean over the iterations so far."""
    means = [s["time"] for s in stats]
    return [m * (k + 1) - (means[k - 1] * k if k else 0.0) for k, m in enumerate(means)]


def train(world, ann, imdir, out, iters, batch_size):
    """The trainer on `world` ranks: its json_stats, one dict a line."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={world}", "-m", "detectorch_tpu_torch.tools.train_fast",
           "--fpn", "--e2e", "--masks", "--ann", ann, "--imdir", imdir, "--out", out,
           "--max-iter", str(iters), "--batch-size", str(batch_size),
           "--checkpoint-period", str(iters), "--log-period", "1", "--device-preprocess",
           "--prefetch", "2", "--device", "cuda"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"train_fast on {world} rank(s) failed:\n{proc.stderr[-4000:]}")
    return [json.loads(line.split(": ", 1)[1]) for line in proc.stdout.splitlines()
            if line.startswith("json_stats: ")]


def main() -> int:
    import torch

    from detectorch_tpu_torch.data.synth import build_synth_coco
    from detectorch_tpu_torch.parallel.dryrun import dryrun_multichip, mesh_shape

    cards = torch.cuda.device_count()
    if cards < 2:
        raise SystemExit(f"{cards} CUDA card(s): the check needs at least two")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    summary = {"cards": cards, "mesh": dict(zip(("data", "model"), mesh_shape(cards)))}
    for r in dryrun_multichip(cards, "cuda"):
        print(json.dumps(r), flush=True)
    summary["dryrun"] = "ok"
    with tempfile.TemporaryDirectory(prefix="multicard-") as tmp:
        ann, imdir = build_synth_coco(os.path.join(tmp, "synth"), n_images=IMAGES,
                                      height=480, width=640, seed=1)
        for world in (cards, 1):
            stats = train(world, ann, imdir, os.path.join(tmp, f"run{world}"), ITERS, BATCH)
            if len(stats) != ITERS:
                raise RuntimeError(f"{len(stats)} of {ITERS} iterations logged")
            times = iteration_times(stats)
            for s, t in zip(stats, times):
                print(f"world {world}: iter {s['iter']} {t * 1e3:.1f} ms, loss {s['loss']:.6f}",
                      flush=True)
            summary[f"world{world}"] = {"iter_ms": [t * 1e3 for t in times],
                                        "loss": [s["loss"] for s in stats]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

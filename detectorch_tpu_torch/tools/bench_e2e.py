"""End-to-end dataset-evaluation img/s: image files on disk -> host
preprocess -> batched device program -> mask paste + RLE on the host,
through ``eval/engine.evaluate_dataset`` over a synthetic COCO set.

The counterpart of the JAX repository's ``tools/bench_e2e.py``, with its
flags and its one JSON line:

  python -m detectorch_tpu_torch.tools.bench_e2e [--n 500] [--batch 8] \\
      [--preset e2e_mask_rcnn_R-50-FPN_2x] [--root DIR] [--score-thresh 1e-4] \\
      [--device-preprocess] [--device cpu]

The set is the port's ``data/synth.build_synth_coco`` at 640x960 with JPGs
and seed 11 (under the checkout's build/ unless --root says). Weights are the
port's probe weights where ``tools/probe_weights`` has cached them for the
preset's family (real-looking box geometry), else ``init_params(seed 0)``.
One slice of 2 * batch images warms the engines (the kernels build there),
then the timed ``evaluate_dataset`` reuses them. JAX's warm-up of its slab
rerun program has no counterpart: the port's RoIAlign is exact for every
roi.

The line holds images_per_sec (host loading, device work, paste and RLE;
COCOeval after the loop excluded), its load/submit/finalize split
(``info["phase_seconds"]``), the detections, the batches, the RoIAlign
launches, peak memory and the device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.config import PRESETS, TestConfig
from detectorch_tpu_torch.tools import measure

# under the checkout's build/, which .gitignore lists
DEFAULT_ROOT = str(Path(__file__).resolve().parents[2] / "build" / "synth_e2e")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_params(cfg):
    """The port's cached probe weights of cfg's family (``tools/probe_weights``,
    harness shapes) when present, else init_params(seed 0): (params, which)."""
    import pickle

    from detectorch_tpu_torch.models.detector import init_params
    from detectorch_tpu_torch.tools import probe_weights as pw

    cache = os.path.join(pw.DEFAULT_ROOT, f"torch_weights_{pw.family_of(cfg.name)}_harness.pkl")
    if cfg.arch == "resnet50" and cfg.use_fpn and os.path.exists(cache):
        with open(cache, "rb") as f:
            return params_from_jax(pickle.load(f)), f"probe weights {cache}"
    return params_from_jax(init_params(cfg, seed=0)), "init_params(seed 0)"


def run(cfg, test_cfg, n: int, batch: int, root: str, device: torch.device,
        params: Optional[Dict] = None, verbose: bool = True, height: int = 640,
        width: int = 960, keep: Optional[Dict] = None) -> Dict:
    """Build (or reuse) the set of `n` height x width images, warm the
    engines, time ``evaluate_dataset``; returns the JSON line (printed).
    `keep`, a dict, receives evaluate_dataset's info as "info"."""
    from detectorch_tpu_torch.data.coco import CocoDataset
    from detectorch_tpu_torch.data.synth import build_synth_coco
    from detectorch_tpu_torch.eval.engine import evaluate_dataset, plan_batches

    t0 = time.perf_counter()
    ann, imdir = build_synth_coco(root, n_images=n, height=height, width=width, seed=11,
                                  img_format="jpg")
    dataset = CocoDataset(ann, imdir)
    log(f"bench_e2e: dataset of {n} images ready in {time.perf_counter() - t0:.1f} s")
    which = "given"
    if params is None:
        params, which = bench_params(cfg)
    log(f"bench_e2e: {cfg.name} weights: {which}")

    engines = {}
    t0 = time.perf_counter()
    evaluate_dataset(cfg, test_cfg, params, dataset, limit=2 * batch, batch_size=batch,
                     verbose=False, engines=engines, device=device)
    measure.synchronize(device)
    log(f"bench_e2e: warm-up (kernel build included) {time.perf_counter() - t0:.1f} s")

    roidb = dataset.get_roidb(gt=False)
    measure.reset_peak_memory(device)
    start = measure.launches()
    t0 = time.perf_counter()
    _, _, info = evaluate_dataset(cfg, test_cfg, params, dataset, roidb=roidb,
                                  batch_size=batch, verbose=verbose, engines=engines,
                                  device=device)
    total = time.perf_counter() - t0
    counts = measure.launches_since(start)
    if keep is not None:
        keep["info"] = info
    if batch > 1:
        eng = engines[("batched", batch)]
        batches = len(plan_batches([eng.key_of_dims(e.height, e.width) for e in roidb], batch))
    else:
        batches = len(roidb)
    rate = info["images_per_sec"]
    log(f"bench_e2e: total {total:.1f} s, inference-loop rate {rate:.2f} img/s, "
        f"{len(info['bbox'])} dets, {len(info['segm'])} rles")
    return measure.emit({
        "metric": "e2e_evaluate_dataset_throughput",
        "value": rate,
        "images_per_sec": rate,
        "unit": (f"images/sec (batch {batch}, {n} images, "
                 + ("masks+RLE" if cfg.use_mask else "boxes") + ", incl host"
                 + (", device-preprocess" if test_cfg.device_preprocess else "") + ")"),
        "detections": len(info["bbox"]),
        "segms": len(info["segm"]),
        "phase_seconds": info["phase_seconds"],
        "seconds_with_cocoeval": total,
        "images": len(roidb),
        "batches": batches,
        "launches": counts,
        "peak_memory_gib": measure.peak_memory_gib(device),
        "weights": which,
        "device": measure.device_info(device),
    })


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=500)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--preset", default="e2e_mask_rcnn_R-50-FPN_2x")
    p.add_argument("--root", default=DEFAULT_ROOT)
    p.add_argument("--score-thresh", type=float, default=1e-4,
                   help="low threshold => ~100 detections+masks per image "
                        "(worst-case host pasting load)")
    p.add_argument("--device-preprocess", action="store_true",
                   help="upload raw uint8 and resize/normalize on the device")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = measure.resolve_device(args.device, "bench_e2e")
    cfg = PRESETS[args.preset]
    tcfg = TestConfig(score_thresh=args.score_thresh, device_preprocess=args.device_preprocess)
    return run(cfg, tcfg, args.n, args.batch, args.root, device)


if __name__ == "__main__":
    main()

"""The AP of the production tier: ``evaluate_dataset`` at each production
ingredient in turn, on the card, against the fp32 plain path.

The port's counterpart of ``examples/fpn_production_ap.py``,
``examples/c4_precision_ap.py`` and ``examples/multiscale_ap.py``, in one
module. Weights are the port's own probe fit (``tools/probe_weights``) on
the synthetic COCO sets of ``data/synth``: 24 images at 224x288 (seed 5) for
the Mask/Faster R-CNN presets, 16 person-keypoints images (seed 6) for
Keypoint R-CNN.

The ladder, per preset, cumulative toward production:

  1. fp32/plain: fp32 compute, CPU tensors, so every RoIAlign is the plain
     PyTorch version; exact blob dims (the baseline every delta is taken
     against);
  2. fp32/kernel: the same on the card, through the RoIAlign kernels (the
     box call, then the mask or keypoint call), TF32 off;
  3. bf16/kernel: + bf16 compute;
  4. bf16/kernel/buckets: + the 832x1344 shape buckets (exact_blob_dims off);
  5. bf16/kernel/buckets/devpre: + device_preprocess (uint8 upload, resize
     on the card);
  6. production batched: + the batched engine at batch 4 with the bf16 mask
     fetch (the full production path).

Rows 3-6 run with torch's TF32 settings as the caller left them (torch's
defaults: cuDNN TF32 on, matmul TF32 off); each row prints them.

The JAX scripts' TPU-only rows are left out. The port refuses the
RoIAlign forward tiers 'bf16x3' and 'bf16' (``ops/cuda/roi_align_kernel.py``
``check_precision``) and C4's separable 'bf16' matmul tier
(``ops/roi_align.check_matmul_precision``); its C4 'high' and 'highest'
both run the exact fp32 form. So ``c4_precision_ap.py``'s rows collapse
into rows 2 (fp32) and 3 (bf16 compute) of the C4 preset.

``--multiscale`` adds ``multiscale_ap.py``'s rows: target_sizes [256],
[192, 256] and [192, 256, 320] on the flagship in the single-image engine,
fp32, TF32 off. The probes are fitted at one scale, so these rows show that
the multi-scale path is wired and well-behaved, not the gain real weights
get from it.

  python -m detectorch_tpu_torch.tools.production_ap \\
      [--presets FPN,C4] [--variants kernel,batched] [--multiscale] \\
      [--shapes harness|production] [--images N] [--root DIR] [--device cpu]

It runs on the card and raises when none is found. ``--device cpu`` fits
the probes on the CPU and runs row 1 alone: the card rows are refused there.
``--presets`` and ``--variants`` take comma-separated substrings; row 1
always runs. Each row prints one JSON line: the preset and variant, the
12 COCO stats per task (bbox, and segm or keypoints), AP@[.5:.95] per task,
its change and the largest change of any stat against row 1, the RoIAlign
launches and requests, and the seconds.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import List, NamedTuple

import numpy as np
import torch

from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.config import ModelConfig, TestConfig
from detectorch_tpu_torch.eval.engine import evaluate_dataset, plan_batches
from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd, roi_align_fwd
from detectorch_tpu_torch.tools import probe_weights as pw

PRESETS_TO_CHECK = (
    "e2e_mask_rcnn_R-50-FPN_2x",
    "e2e_faster_rcnn_R-50-FPN_2x",
    "e2e_mask_rcnn_R-50-C4_2x",
    "e2e_keypoint_rcnn_R-50-FPN_1x",
)
MULTISCALE_PRESET = "e2e_mask_rcnn_R-50-FPN_2x"
MULTISCALE_SIZES = ((256,), (192, 256), (192, 256, 320))
DEFAULT_ROOT = str(Path(pw.DEFAULT_ROOT).parent / "production_ap")
PRODUCTION_BATCH = 4


class Variant(NamedTuple):
    label: str
    cfg: ModelConfig
    tcfg: TestConfig
    batch: int
    on_card: bool    # False: row 1, CPU tensors (the plain versions)
    tf32_off: bool


def ladder(cfg: ModelConfig, tcfg: TestConfig) -> List[Variant]:
    """The six rows, cumulative toward the production path."""
    prod = cfg.replace(compute_dtype="bfloat16")
    buckets = tcfg.replace(exact_blob_dims=False)
    devpre = buckets.replace(device_preprocess=True)
    return [
        Variant("fp32/plain (baseline)", cfg, tcfg, 1, False, True),
        Variant("fp32/kernel", cfg, tcfg, 1, True, True),
        Variant("bf16/kernel", prod, tcfg, 1, True, False),
        Variant("bf16/kernel/buckets", prod, buckets, 1, True, False),
        Variant("bf16/kernel/buckets/devpre", prod, devpre, 1, True, False),
        Variant("production batched (bf16 masks)", prod, devpre, PRODUCTION_BATCH, True, False),
    ]


def _matches(name: str, filters) -> bool:
    return not filters or any(s in name for s in filters)


def _dataset(family: str, root: str, images):
    """(dataset, its directory): the synthetic set a family's probes are
    fitted and scored on, under `root` (one directory per set and size)."""
    if family == "r50_fpn_kp":
        n = images or 16
        where = str(Path(root) / f"synth_kp_{n}")
        return pw.prepare_keypoint_dataset(where, n_images=n), where
    n = images or 24
    where = str(Path(root) / f"synth_{n}")
    return pw.prepare_dataset(where, n_images=n)[0], where


def _stats(cfg, bbox, segm, info):
    """{task: 12 (or 10 OKS) COCO stats} of one evaluation."""
    out = {"bbox": bbox}
    if cfg.use_mask:
        out["segm"] = segm
    if cfg.keypoint is not None:
        out["keypoints"] = info["keypoints_stats"]
    return {k: [float(x) for x in v] for k, v in out.items()}


def evaluate_row(preset, label, cfg, tcfg, params, dataset, device, batch=1, tf32_off=False,
                 base=None, target_sizes=None, shapes="harness", echo=True, rung=None):
    """One evaluate_dataset run -> its row, printed as a JSON line when
    `echo` (deltas against `base`, a row of the same preset, when given;
    `rung`, the ladder's row number 1-6, when given)."""
    roidb = dataset.get_roidb(gt=False)
    engines = {}
    fwd0, bwd0 = roi_align_fwd.launches, roi_align_bwd.launches
    t0 = time.perf_counter()
    with pw.no_tf32() if tf32_off else contextlib.nullcontext():
        tf32 = {"cudnn": torch.backends.cudnn.allow_tf32,
                "matmul": torch.backends.cuda.matmul.allow_tf32}
        bbox, segm, info = evaluate_dataset(cfg, tcfg, params, dataset, roidb=roidb,
                                            verbose=False, batch_size=batch, engines=engines,
                                            target_sizes=target_sizes, device=device)
    seconds = time.perf_counter() - t0
    if batch > 1:
        eng = engines[("batched", batch)]
        requests = len(plan_batches([eng.key_of_dims(e.height, e.width) for e in roidb], batch))
    else:
        requests = len(roidb)
    stats = _stats(cfg, bbox, segm, info)
    row = {"preset": preset, "variant": label, "shapes": shapes, "device": str(device),
           "batch": batch, "images": len(roidb), "requests": requests}
    if rung is not None:
        row["row"] = rung
    if target_sizes is not None:
        row["target_sizes"] = list(target_sizes)
    row.update({f"{task}_ap": v[0] for task, v in stats.items()})
    if base is not None:
        row["ap_delta_vs_row1"] = {t: v[0] - base["stats"][t][0] for t, v in stats.items()}
        row["max_delta_vs_row1"] = float(max(
            np.max(np.abs(np.subtract(v, base["stats"][t]))) for t, v in stats.items()))
    row.update({"launches": {"roi_align_fwd": roi_align_fwd.launches - fwd0,
                             "roi_align_bwd": roi_align_bwd.launches - bwd0},
                "detections": len(info["bbox"]), "tf32": tf32, "seconds": seconds,
                "stats": stats})
    if echo:
        print(json.dumps(row), flush=True)
    return row


def fitted_params(preset: str, device, root: str, shapes: str = "harness", images=None):
    """(dataset, port-layout probe weights) of `preset`'s family, fitted on
    `device` (cached beside the dataset)."""
    family = pw.family_of(preset)
    dataset, where = _dataset(family, root, images)
    t0 = time.perf_counter()
    weights = pw.make_probe_weights(family, dataset, device=device, cache_root=where,
                                    shapes=shapes)
    print(f"production_ap: {family} probe weights ({shapes} shapes) on {device}: "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return dataset, params_from_jax(weights)


def run_ladder(preset: str, variants=(), device="cuda", root: str = DEFAULT_ROOT,
               shapes: str = "harness", images=None, echo=True):
    """The ladder's rows of `preset` whose label holds one of the substrings
    `variants` (all rows when empty), row 1 always first; on a CPU `device`
    row 1 alone. Returns the rows (each printed as a JSON line when
    `echo`)."""
    device = torch.device(device)
    cfg, tcfg = pw.harness_cfg(preset, shapes)
    dataset, params = fitted_params(preset, device, root, shapes, images)
    rows = []
    chosen = [(i + 1, v) for i, v in enumerate(ladder(cfg, tcfg))
              if i == 0 or (device.type == "cuda" and _matches(v.label, variants))]
    for rung, v in chosen:
        dev = device if v.on_card else torch.device("cpu")
        rows.append(evaluate_row(preset, v.label, v.cfg, v.tcfg, params, dataset, dev, v.batch,
                                 v.tf32_off, rows[0] if rows else None, shapes=shapes,
                                 echo=echo, rung=rung))
    return rows


def run_multiscale(device="cuda", root: str = DEFAULT_ROOT, images=None):
    """``multiscale_ap.py``'s rows on the flagship at harness shapes: each
    of MULTISCALE_SIZES through the single-image engine on `device`, fp32,
    TF32 off; deltas against the single-scale row."""
    device = torch.device(device)
    cfg, tcfg = pw.harness_cfg(MULTISCALE_PRESET)
    dataset, params = fitted_params(MULTISCALE_PRESET, device, root, images=images)
    rows = []
    for z in MULTISCALE_SIZES:
        rows.append(evaluate_row(MULTISCALE_PRESET, f"multiscale {list(z)}", cfg, tcfg, params,
                                 dataset, device, tf32_off=True,
                                 base=rows[0] if rows else None, target_sizes=list(z)))
    return rows


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--presets", default="",
                   help="comma-separated substrings of the presets to run (default all four)")
    p.add_argument("--variants", default=None,
                   help="comma-separated substrings of the rows to run after row 1 "
                        "(default all rows; none with --device cpu)")
    p.add_argument("--multiscale", action="store_true",
                   help="also run the multi-scale rows on the flagship (harness shapes)")
    p.add_argument("--shapes", choices=["harness", "production"], default="harness")
    p.add_argument("--images", type=int, default=None,
                   help="images per synthetic set (default 24, and 16 for keypoints)")
    p.add_argument("--root", default=DEFAULT_ROOT,
                   help="where the synthetic sets and the cached probe weights live")
    p.add_argument("--device", default="cuda", help="the card rows' device, or cpu")
    args = p.parse_args(argv)
    if args.multiscale and args.shapes != "harness":
        p.error("--multiscale runs at harness shapes (target sizes 192-320)")
    return args


def _split(s):
    return [x for x in s.split(",") if x]


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("production_ap runs on the card, and torch.cuda.is_available() is "
                           "False; --device cpu runs the fp32 plain baseline (row 1) alone")
    if device.type == "cpu" and args.variants:
        raise ValueError(f"--variants {args.variants!r}: rows 2-6 run through the RoIAlign "
                         "kernels on the card; --device cpu runs row 1 alone")
    rows = []
    for preset in PRESETS_TO_CHECK:
        if _matches(preset, _split(args.presets)):
            rows += run_ladder(preset, _split(args.variants or ""), device, args.root,
                               args.shapes, args.images)
    if args.multiscale:
        rows += run_multiscale(device, args.root, args.images)
    return rows


if __name__ == "__main__":
    main()

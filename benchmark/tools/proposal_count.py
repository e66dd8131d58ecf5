"""Does each configuration's RPN fill its post-NMS slots, and does the
port keep the reference's proposals?

    python3 benchmark/tools/proposal_count.py [--seed N] [--device cuda]

For each configuration, on the first batch of the cell's pool (8 images at
832x1344), and on the port's ``tools/bench`` input (8 blobs of
``randn * 50`` at 832x1344, im_scale 1.66, 500x800 originals): the
proposals of the port in fp32 (TF32 off) and in bf16, and the
reference's (fp32), with the benchmark's weights for the seed; per
image, the slots filled, and how many of the port's fp32 proposals lie
under IoU 0.99 against every reference proposal. For contrast the same
counts with the port's own random init (``init_params(seed 0)``, unscaled),
the weights its tools use. One JSON line per configuration and weights.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELLS = {"e2e_mask_rcnn_R-50-FPN_2x": "fpn_mask.infer_b8",
         "e2e_mask_rcnn_R-50-C4_2x": "c4_mask.infer_b8"}


def count(cfg, mix, blobs, port_params, device, batch):
    import torch

    from benchmark.harness import check, program
    from benchmark.reference import boxes as bx
    from benchmark.reference import model as M

    model_cfg, test_cfg = program.port_configs(cfg)
    row = {}
    with check.fp32_only():
        for dtype in ("float32", "bfloat16"):
            fn = program.inference_fn(model_cfg.replace(compute_dtype=dtype), test_cfg, device)
            out = fn(port_params, *batch)
            row[f"port_{dtype}_filled"] = out.roi_valid.sum(dim=1).tolist()
            if dtype == "float32":
                port32 = out
        if blobs is None:
            return row
        filled, miss = [], []
        q = M.Precision("float32")
        images, im_scale, orig_h, orig_w = batch
        for i in range(images.shape[0]):
            feats = M.features(cfg, blobs, q, images[i:i + 1])
            im_h, im_w = M.bounds(cfg, images.shape[1:3], im_scale[i:i + 1], orig_h[i:i + 1],
                                  orig_w[i:i + 1])
            ref = M.proposals(cfg, blobs, q, feats, im_h, im_w, im_scale[i:i + 1])
            filled.append(int(ref.valid.sum()))
            mine = port32.rois[i][port32.roi_valid[i]]
            theirs = ref.boxes[0][ref.valid[0]]
            best = bx.bbox_overlaps(mine, theirs).max(dim=1).values
            miss.append(int((best < 0.99).sum()))
        row["reference_filled"] = filled
        row["port_fp32_under_iou_0.99"] = miss
    return row


def main(argv=None):
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import run
    from benchmark.harness import program
    from benchmark.harness.traffic import Batch, make_pool
    from benchmark.harness.weights import make_blobs
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.models.detector import init_params

    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=2 ** 31 + 99)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for name, cell_name in CELLS.items():
        spec, w, cell, cfg, mix = run.load_cell(cell_name)
        device = torch.device(args.device) if args.device == "cpu" else run.device_check(1)
        model_cfg, _ = program.port_configs(cfg)
        blobs = make_blobs(cfg, args.seed, device)
        ours = program.load_params(blobs, model_cfg, device)
        own = params_to_device(params_from_jax(init_params(model_cfg, seed=0)), device)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        inputs = {"traffic": make_pool(dict(mix, pool_batches=1), args.seed, device)[0],
                  "bench_noise": Batch(torch.randn((8, 832, 1344, 3), generator=gen,
                                                   device=device) * 50,
                                       *(torch.full((8,), v, device=device)
                                         for v in (1.66, 500.0, 800.0)))}
        for what, batch in inputs.items():
            row = count(cfg, mix, blobs, ours, device, batch)
            print(json.dumps({"config": name, "input": what,
                              "weights": f"benchmark, seed {args.seed}", **row}), flush=True)
            row = count(cfg, mix, None, own, device, batch)
            print(json.dumps({"config": name, "input": what, "weights": "init_params(seed 0)",
                              **row}), flush=True)


if __name__ == "__main__":
    main()

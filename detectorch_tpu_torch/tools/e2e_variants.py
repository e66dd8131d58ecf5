"""Time parts of the e2e training step on one CUDA card, on phase 10's inputs.

    python3 -m detectorch_tpu_torch.tools.e2e_variants   # from the root of a checkout

On the batch of ``chip_smoke.py``'s phase 10 (``make_e2e_batch``: 8
COCO-sized uint8 images resized into 832x1344, 3-20 gts in 128 slots;
init_params(seed 0), bf16, RPN 12000 -> 2000 per level), each timed by CUDA
events after a warm-up, with the card's name and power limit:

  * ``rpn_targets`` as the step runs it (on the gt slots up to the last
    valid one) and on all 128 slots: ms and the peak memory it adds;
  * the train-count proposals (``models.detector.fpn_proposals``: the decode,
    one batched NMS over 40 rows of up to 12,032 boxes, the collect): ms,
    the NMS's fixpoint tests (one host sync each), and the ms of its dense
    IoU suppression passes alone (its ``bbox_overlaps`` calls of each
    128-box block against every later box, on boxes of the same shapes
    (the levels' score-sorted anchors), without the fixpoint).

Prints one JSON line per measurement.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ITERS = 5


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("e2e_variants: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.config import PRESETS
    from detectorch_tpu_torch.models import rpn as rpn_mod
    from detectorch_tpu_torch.models.detector import (
        backbone_features,
        fpn_proposals,
        init_params,
        level_anchors,
        rpn_feature_levels,
    )
    from detectorch_tpu_torch.ops import nms as nms_mod
    from detectorch_tpu_torch.ops.boxes import bbox_overlaps
    from detectorch_tpu_torch.train import e2e
    from detectorch_tpu_torch.train.train_step import device_images

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    cfg = PRESETS[cs.PRESET]
    params = params_to_device(params_from_jax(init_params(cfg, seed=0)), dev)
    b = cs.make_e2e_batch(np.random.RandomState(10), cs.E2E_SIZES, (cs.HEIGHT, cs.WIDTH), 800,
                          1333, (3, 20), dev)
    info = b["meta"][:, 2:5]
    bsz = b["raw"].shape[0]
    with torch.no_grad():
        pyramid = backbone_features(params, cfg, device_images(b, (cs.HEIGHT, cs.WIDTH)))
        feats, levels = rpn_feature_levels(cfg, pyramid)
        heads = [rpn_mod.rpn_head(params, f, prefix="_fpn2", return_logits=True) for f in feats]
    cache = {}
    anchors = torch.cat([level_anchors(cfg, lg.shape[1], lg.shape[2], lvl, dev, cache)
                         for (lg, _), lvl in zip(heads, levels)])
    u = e2e.torch_uniforms(0)(0, bsz, anchors.shape[0], cs.TRAIN_POST + 128, dev)

    def emit(what, **kw):
        print(json.dumps({"what": what, "card": card, **kw}), flush=True)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / ITERS, (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30

    def targets():
        return e2e.rpn_targets(anchors, b["gt_boxes"], b["gt_valid"], info[:, 0], info[:, 1],
                               u["anchor_pos"], u["anchor_neg"])

    used = e2e._used_gt_columns(b["gt_valid"])
    ms, gib = timed(targets)
    emit("rpn_targets", gt_columns=used, ms=ms, peak_added_gib=gib)
    trimmed = targets()
    e2e._used_gt_columns = lambda gt_valid: gt_valid.shape[1]
    ms, gib = timed(targets)
    emit("rpn_targets", gt_columns=int(b["gt_valid"].shape[1]), ms=ms, peak_added_gib=gib)
    full = targets()
    assert all(torch.equal(x, y) for x, y in zip(trimmed, full)), "the trim changed the targets"

    probs = [torch.sigmoid(lg) for lg, _ in heads]
    deltas = [dl for _, dl in heads]

    def proposals():
        return fpn_proposals(cfg, probs, deltas, levels, info[:, 0], info[:, 1], info[:, 2],
                             cs.TRAIN_PRE, cs.TRAIN_POST, cache)

    tests = []
    equal = torch.equal

    def counting_equal(x, y):
        tests.append(1)
        return equal(x, y)

    nms_mod.torch.equal = counting_equal
    try:
        ms, gib = timed(proposals)
    finally:
        nms_mod.torch.equal = equal
    emit("fpn_proposals", pre=cs.TRAIN_PRE, post=cs.TRAIN_POST, ms=ms, peak_added_gib=gib,
         fixpoint_tests_per_call=len(tests) / (ITERS + 1))

    # the NMS's suppression passes alone, over its own sorted inputs
    boxes = []
    for p, lvl in zip(probs, levels):
        k = min(cs.TRAIN_PRE, p[0].numel())
        _, idx = nms_mod.topk_stable(p.reshape(bsz, -1), k)
        a = level_anchors(cfg, p.shape[1], p.shape[2], lvl, dev, cache)[idx]
        boxes.append(torch.nn.functional.pad(a, (0, 0, 0, cs.TRAIN_PRE - k)))
    boxes = torch.stack(boxes, 1).reshape(-1, cs.TRAIN_PRE, 4)
    n = -(-cs.TRAIN_PRE // 128) * 128
    boxes = torch.nn.functional.pad(boxes, (0, 0, 0, n - cs.TRAIN_PRE))

    alive = torch.ones(boxes.shape[:2], dtype=torch.bool, device=dev)

    def suppress_passes():
        suppressed = torch.zeros_like(alive)
        for start in range(0, n - 128, 128):
            stop = start + 128
            hits = (alive[:, start:stop, None]
                    & (bbox_overlaps(boxes[:, start:stop], boxes[:, stop:])
                       >= cfg.rpn.nms_thresh)).any(dim=1)
            suppressed[:, stop:] |= hits

    ms, gib = timed(suppress_passes)
    emit("nms_suppression_passes", rows=int(boxes.shape[0]), width=n, blocks=n // 128, ms=ms,
         peak_added_gib=gib)
    return 0


if __name__ == "__main__":
    sys.exit(main())

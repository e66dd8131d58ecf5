"""Time parts of the e2e training step on one CUDA card, on phase 10's inputs.

    python3 -m detectorch_tpu_torch.tools.e2e_variants

On the batch of ``chip_smoke.py``'s phase 10
(``tools/profile_e2e_train.make_e2e_batch``: 8 COCO-sized uint8 images
resized into 832x1344, 3-20 gts in 128 slots; init_params(seed 0), bf16,
RPN 12000 -> 2000 per level), each timed by CUDA events after a warm-up,
with the card's name and power limit:

  * ``rpn_targets`` as the step runs it (on the gt slots up to the last
    valid one) and on all 128 slots: ms and the peak memory it adds;
  * the train-count proposals (``models.detector.fpn_proposals``: the decode,
    one batched NMS over 40 rows of up to 12,032 boxes, the collect): ms,
    and the NMS kernel's launches a call (2: ``ops/cuda/nms_kernel``).

Prints one JSON line per measurement.
"""

from __future__ import annotations

import json
import subprocess
import sys

ITERS = 5


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("e2e_variants: needs a CUDA card", file=sys.stderr)
        return 1
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
    from detectorch_tpu_torch.ops.cuda.nms_kernel import batched_nms_kernel
    from detectorch_tpu_torch.tools import profile_e2e_train as pe
    from detectorch_tpu_torch.train import e2e
    from detectorch_tpu_torch.train.train_step import device_images

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    cfg = PRESETS[pe.preset_of(masks=True, keypoints=False)]
    params = params_to_device(params_from_jax(init_params(cfg, seed=0)), dev)
    b = pe.make_e2e_batch(np.random.RandomState(10), pe.E2E_SIZES, pe.BLOB_HW, 800,
                          1333, (3, 20), dev)
    info = b["meta"][:, 2:5]
    bsz = b["raw"].shape[0]
    with torch.no_grad():
        pyramid = backbone_features(params, cfg, device_images(b, pe.BLOB_HW))
        feats, levels = rpn_feature_levels(cfg, pyramid)
        heads = [rpn_mod.rpn_head(params, f, prefix="_fpn2", return_logits=True) for f in feats]
    cache = {}
    anchors = torch.cat([level_anchors(cfg, lg.shape[1], lg.shape[2], lvl, dev, cache)
                         for (lg, _), lvl in zip(heads, levels)])
    u = e2e.torch_uniforms(0)(0, bsz, anchors.shape[0], pe.TRAIN_POST + 128, dev)

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
                             pe.TRAIN_PRE, pe.TRAIN_POST, cache)

    launches = batched_nms_kernel.launches
    ms, gib = timed(proposals)
    emit("fpn_proposals", pre=pe.TRAIN_PRE, post=pe.TRAIN_POST, ms=ms, peak_added_gib=gib,
         nms_launches_per_call=(batched_nms_kernel.launches - launches) / (ITERS + 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

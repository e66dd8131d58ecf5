"""The e2e training step's time (or its FLOPs) at the production bucket.

The counterpart of the JAX repository's ``examples/profile_e2e_train.py``:
``train/e2e.make_e2e_train_step`` for e2e_faster_rcnn_R-50-FPN_2x,
e2e_mask_rcnn_R-50-FPN_2x (PROFILE_E2E_MASKS=1) or
e2e_keypoint_rcnn_R-50-FPN_1x (PROFILE_E2E_KEYPOINTS=1), bf16, RPN 12000 ->
2000 per level, 512 sampled rois per image, random init_params(seed 0), on a
fixed uint8 batch (``make_e2e_batch``: COCO-sized noise images resized on
the card into 832x1344, 3-20 polygon gts per image; keypoints inside the
gt boxes on the keypoint preset):

  python -m detectorch_tpu_torch.tools.profile_e2e_train             # the card
  PROFILE_E2E_MASKS=1 PROFILE_E2E_COST=1 python -m detectorch_tpu_torch.tools.profile_e2e_train

Knobs: PROFILE_E2E_BATCH (8), PROFILE_E2E_MASKS, PROFILE_E2E_KEYPOINTS,
PROFILE_E2E_ITERS (8), PROFILE_E2E_ROIALIGN ('gather'; the exact names
only), PROFILE_E2E_ROIALIGN_FWD ('exact' only), PROFILE_E2E_S2D_STEM
(raises), as in JAX; PROFILE_E2E_COST=1 prints the step's FLOPs
(``tools/measure.count_flops``: conv and linear layers forward and
backward, plus both RoIAlign kernels' operations) instead of timing.
BENCH_DEVICE=cpu runs on the CPU. JAX's constant-stage substitutions
(PROFILE_E2E_{MASK_TARGETS,MASK_STAGE,KP_STAGE,RPN_STAGE}) are not ported
and raise: the port splits the step by CUDA events instead
(``chip_smoke.py`` phase 10, ``tools/e2e_variants``).

One JSON line: ms per step and img/s (or the FLOPs), the loss, peak
memory, the RoIAlign launches and the device.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
from detectorch_tpu_torch.config import PRESETS, SamplerConfig, SolverConfig
from detectorch_tpu_torch.models.detector import init_params
from detectorch_tpu_torch.tools import measure

# COCO-like landscape image sizes of the batch; all resize into the
# 832x1344 bucket at target size 800, max size 1333
E2E_SIZES = ((480, 640), (427, 640), (500, 750), (375, 500), (480, 640), (426, 640),
             (512, 683), (640, 853))
BLOB_HW = (832, 1344)
TRAIN_PRE, TRAIN_POST = 12000, 2000  # the reference's train counts
NOT_PORTED = ("PROFILE_E2E_MASK_TARGETS", "PROFILE_E2E_MASK_STAGE", "PROFILE_E2E_KP_STAGE",
              "PROFILE_E2E_RPN_STAGE")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_e2e_batch(rng, orig_sizes, blob_hw, target_size, max_size, gt_range, device,
                   keypoints=0, num_classes=81):
    """An e2e training batch in the uint8 schema, made with numpy: uint8
    noise images of `orig_sizes`, padded to one raw bucket, with their
    resize tables and meta (``data.device_input``); per image a number of
    gts in `gt_range`, each a 12-gon with jittered radii whose tight box is
    the gt box, classes 1 to num_classes - 1, and its raster wrt its own box at
    GT_RASTER_RES (``train.sampler.polys_to_mask_wrt_box``), padded to
    GT_PAD slots as the trainer pads them. With `keypoints` > 0, each gt
    also carries that many keypoints inside its box, input-scaled, a fifth
    unlabelled (v = 0), as gt_keypoints (B, GT_PAD, keypoints, 3)."""
    from detectorch_tpu_torch.data.device_input import RAW_STRIDE, pack_tables_meta, prepare_raw
    from detectorch_tpu_torch.tools.train_fast import GT_PAD
    from detectorch_tpu_torch.train.e2e import GT_RASTER_RES
    from detectorch_tpu_torch.train.sampler import polys_to_mask_wrt_box

    raw_hw = (max(-(-h // RAW_STRIDE) * RAW_STRIDE for h, _ in orig_sizes),
              max(-(-w // RAW_STRIDE) * RAW_STRIDE for _, w in orig_sizes))
    out = {k: [] for k in ("raw", "tables", "meta", "gt_boxes", "gt_classes", "gt_valid",
                           "gt_masks", "gt_mask_valid")}
    if keypoints:
        out["gt_keypoints"] = []
    for h, w in orig_sizes:
        raw, m = prepare_raw(rng.randint(0, 256, (h, w, 3)).astype(np.uint8), target_size,
                             max_size, buckets=(blob_hw,))
        padded = np.zeros(raw_hw + (3,), np.uint8)
        padded[: raw.shape[0], : raw.shape[1]] = raw
        tables, meta = pack_tables_meta(m)
        n = rng.randint(gt_range[0], gt_range[1] + 1)
        boxes = np.zeros((GT_PAD, 4), np.float32)
        masks = np.zeros((GT_PAD, GT_RASTER_RES, GT_RASTER_RES), np.uint8)
        for j in range(n):
            radius = rng.uniform(0.03, 0.3) * min(h, w)
            cx, cy = rng.uniform(radius, w - radius), rng.uniform(radius, h - radius)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 12))
            rad = radius * (0.6 + 0.4 * rng.rand(12))
            px, py = cx + rad * np.cos(ang), cy + rad * np.sin(ang)
            box = np.array([px.min(), py.min(), px.max(), py.max()])
            masks[j] = polys_to_mask_wrt_box([np.stack([px, py], 1).reshape(-1)], box,
                                             GT_RASTER_RES)
            boxes[j] = box * m["scale"]
        if keypoints:
            kxy = boxes[:, None, :2] + rng.uniform(0, 1, (GT_PAD, keypoints, 2)) \
                * (boxes[:, None, 2:] - boxes[:, None, :2])
            vis = np.where(rng.rand(GT_PAD, keypoints) < 0.2, 0.0, 2.0)
            vis[n:] = 0.0
            out["gt_keypoints"].append(
                np.concatenate([kxy, vis[..., None]], -1).astype(np.float32))
        valid = np.arange(GT_PAD) < n
        for k, v in (("raw", padded), ("tables", tables), ("meta", meta), ("gt_boxes", boxes),
                     ("gt_classes",
                      np.where(valid, rng.randint(1, num_classes, GT_PAD), 0).astype(np.int32)),
                     ("gt_valid", valid), ("gt_masks", masks), ("gt_mask_valid", valid)):
            out[k].append(v)
    return {k: torch.from_numpy(np.stack(v)).to(device) for k, v in out.items()}


def preset_of(masks: bool, keypoints: bool) -> str:
    """JAX's choice: keypoints, else masks, else Faster R-CNN."""
    return ("e2e_keypoint_rcnn_R-50-FPN_1x" if keypoints
            else "e2e_mask_rcnn_R-50-FPN_2x" if masks else "e2e_faster_rcnn_R-50-FPN_2x")


def e2e_setup(cfg, device: torch.device, batch: int = 8, sizes: Optional[Sequence] = None,
              blob_hw: Tuple[int, int] = BLOB_HW, target_size: int = 800,
              max_size: int = 1333, pre: int = TRAIN_PRE, post: int = TRAIN_POST,
              rois_per_image: int = 512, gt_range=(3, 20), roi_align_impl: str = "gather",
              params: Optional[Dict] = None, solver: SolverConfig = SolverConfig()):
    """(state, step, batch) of the e2e step: init_params(seed 0) (unless
    `params`, port-layout tensors, are given), ``make_e2e_train_step`` with
    the mask branch on a mask preset and the keypoint branch on a keypoint
    preset, and a ``make_e2e_batch`` batch of `batch` images (E2E_SIZES in
    turn, or `sizes`) from RandomState(10)."""
    from detectorch_tpu_torch.train.e2e import make_e2e_train_step

    if params is None:
        params = params_from_jax(init_params(cfg, seed=0))
    params = params_to_device(params, device)
    kps = cfg.keypoint is not None
    init_state, make_step = make_e2e_train_step(
        cfg, solver, SamplerConfig(rois_per_image=rois_per_image), seed=0, train_pre_nms=pre,
        train_post_nms=post, train_mask=cfg.use_mask, train_keypoints=kps, device_input=True,
        blob_hw=blob_hw, roi_align_impl=roi_align_impl)
    state, opt = init_state(params)
    sizes = sizes or [E2E_SIZES[i % len(E2E_SIZES)] for i in range(batch)]
    blobs = make_e2e_batch(np.random.RandomState(10), sizes, blob_hw, target_size, max_size,
                           gt_range, device, keypoints=cfg.keypoint.num_keypoints if kps else 0,
                           num_classes=cfg.num_classes)
    return state, make_step(opt), blobs


def step_flops(state, step, blobs):
    """The FLOPs of one step (``measure.count_flops``); returns (state
    after the step, count)."""
    (state, _), count = measure.count_flops(lambda: step(state, blobs))
    return state, count


def profile(cfg, device: torch.device, iters: int = 8, cost: bool = False, **setup) -> Dict:
    """Time `iters` e2e steps after one warm-up step (or, with `cost`,
    count one step's FLOPs); returns the JSON line (printed)."""
    state, step, blobs = e2e_setup(cfg, device, **setup)
    bsz = blobs["raw"].shape[0]
    line = {"tool": "profile_e2e_train", "preset": cfg.name, "batch": bsz,
            "blob_hw": list(setup.get("blob_hw", BLOB_HW)),
            "pre_post": [setup.get("pre", TRAIN_PRE), setup.get("post", TRAIN_POST)],
            "compute_dtype": cfg.compute_dtype}
    if cost:
        start = measure.launches()
        _, count = step_flops(state, step, blobs)
        measure.synchronize(device)
        line.update(flops_per_step=count["flops"], flops_per_image=count["flops"] / bsz,
                    count=count, launches=measure.launches_since(start),
                    device=measure.device_info(device))
        log(f"profile_e2e_train: {count['flops'] / 1e12:.3f} TFLOP/step (batch {bsz}, "
            f"{count['flops'] / bsz / 1e9:.1f} GFLOP/img)")
        return measure.emit(line)

    def run_once():
        nonlocal state
        state, metrics = step(state, blobs)
        return metrics

    _, first = measure.host_ms(run_once, device)
    log(f"profile_e2e_train: first step (kernel build included): {first / 1e3:.1f} s")
    measure.reset_peak_memory(device)
    start = measure.launches()
    ms = []
    for _ in range(iters):
        metrics, t = measure.host_ms(run_once, device)
        ms.append(t)
    mean = sum(ms) / len(ms)
    line.update(ms_per_step=mean, images_per_sec=bsz * 1e3 / mean, ms=ms,
                loss=float(metrics["loss"]), launches=measure.launches_since(start),
                steps=iters, peak_memory_gib=measure.peak_memory_gib(device),
                device=measure.device_info(device))
    log(f"profile_e2e_train: steady {mean:.1f} ms/step -> {bsz * 1e3 / mean:.1f} img/s")
    return measure.emit(line)


def config_from_env(env: Mapping):
    masks = env.get("PROFILE_E2E_MASKS", "") == "1"
    kps = env.get("PROFILE_E2E_KEYPOINTS", "") == "1"
    cfg = PRESETS[preset_of(masks, kps)]
    if env.get("PROFILE_E2E_S2D_STEM"):
        cfg = cfg.replace(s2d_stem=True)
    if env.get("PROFILE_E2E_ROIALIGN_FWD"):
        cfg = cfg.replace(roi_align_fwd_precision=env["PROFILE_E2E_ROIALIGN_FWD"])
    return cfg


def main(env: Optional[Mapping] = None) -> Dict:
    env = os.environ if env is None else env
    device = measure.resolve_device(env.get("BENCH_DEVICE", "cuda"), "profile_e2e_train",
                                    "BENCH_DEVICE=cpu")
    for name in NOT_PORTED:
        if env.get(name):
            raise NotImplementedError(
                f"{name}: JAX's constant-stage substitution is not ported; the port splits "
                "the step by CUDA events (chip_smoke.py phase 10, tools/e2e_variants)")
    return profile(config_from_env(env), device, iters=int(env.get("PROFILE_E2E_ITERS", "8")),
                   cost=env.get("PROFILE_E2E_COST", "") == "1",
                   batch=int(env.get("PROFILE_E2E_BATCH", "8")),
                   roi_align_impl=env.get("PROFILE_E2E_ROIALIGN", "gather"))


if __name__ == "__main__":
    main()

"""Fast R-CNN / Mask R-CNN training on the FPN path, in PyTorch.

Port of ``tools/train_fast.py`` for ``--fpn`` and ``--fpn --masks``: the
Detectron 2x schedule (SGD momentum 0.9, wd 1e-4, step-decay LR with
linear warmup, grad clip 35, conv1 + res2 frozen) from precomputed
proposals, with the same argument names and defaults for the options it
keeps, ``ckpt-<step>`` checkpoints under --out and ``--resume``. The roidb
comes from ``data.coco.roidb_for_training``; images are read and resized by
``data.transforms`` and mask targets rasterised by ``train.sampler``, both
of which use OpenCV (cv2).

  python -m detectorch_tpu_torch.tools.train_fast --fpn \\
      --ann instances_train2014.json --imdir train2014 \\
      --proposals proposals.pkl --out runs/fast_rcnn

--base-cnn loads an ImageNet base CNN from a Detectron ``.pkl``
(``checkpoint.caffe2_import.import_base_cnn``); the heads keep their random
init. Not ported yet, and refused: --e2e, --keypoints, --device-preprocess
and the C4 presets (no --fpn).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ann", required=True, help="COCO annotation json")
    p.add_argument("--imdir", required=True, help="image directory")
    p.add_argument("--proposals", default=None,
                   help="proposal .pkl file; omitted -> train on gt boxes only "
                        "(allowed with --masks)")
    p.add_argument("--base-cnn", default=None,
                   help="ImageNet base CNN .pkl (Detectron layout)")
    p.add_argument("--arch", default="resnet50", choices=["resnet50", "resnet101"])
    p.add_argument("--fpn", action="store_true")
    p.add_argument("--out", default="runs/fast_rcnn")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: 1 (one device)")
    p.add_argument("--max-iter", type=int, default=360000)
    p.add_argument("--base-lr", type=float, default=0.01)
    p.add_argument("--checkpoint-period", type=int, default=20000)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-period", type=int, default=20)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--device-preprocess", action="store_true",
                   help="uint8 upload with on-device resize (not ported yet: refused)")
    p.add_argument("--target-size", type=int, default=800,
                   help="resize shorter side to this (reference 800)")
    p.add_argument("--max-size", type=int, default=1333,
                   help="cap longer side at this (reference 1333)")
    p.add_argument("--blob", type=int, nargs=2, default=(1344, 1344), metavar=("H", "W"),
                   help="fixed training blob bucket")
    p.add_argument("--rois-per-image", type=int, default=512)
    p.add_argument("--roi-align", choices=["auto", "gather", "pallas", "pallas-mm", "pallas-slab"],
                   default="auto",
                   help="the JAX package's RoIAlign names; the port's RoIAlign is exact, so "
                        "every accepted name runs the same CUDA forward and backward "
                        "kernels ('pallas-mm' only at --roi-align-bwd-precision highest)")
    p.add_argument("--roi-align-bwd-precision", choices=["bf16", "high", "highest"],
                   default="bf16", help="tier of 'pallas-mm'; only 'highest' is ported")
    p.add_argument("--roi-align-fwd-precision", choices=["exact", "bf16x3", "bf16"],
                   default="exact", help="only 'exact' is ported")
    p.add_argument("--keypoints", action="store_true", help="not ported yet: refused")
    p.add_argument("--masks", action="store_true",
                   help="train Mask R-CNN: box branch + mask head with "
                        "polys_to_mask_wrt_box targets")
    p.add_argument("--e2e", action="store_true", help="not ported yet: refused")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    args = p.parse_args(argv)
    for flag in ("e2e", "keypoints", "device_preprocess"):
        if getattr(args, flag):
            p.error(f"--{flag.replace('_', '-')} is not ported to PyTorch yet")
    if args.base_cnn and not os.path.isfile(args.base_cnn):
        p.error(f"--base-cnn {args.base_cnn}: no such file")
    if not args.fpn:
        p.error("the C4 presets are not ported to PyTorch yet: pass --fpn")
    if not args.masks and not args.proposals:
        # Fast R-CNN needs hard negatives from precomputed proposals
        p.error("--proposals is required unless --masks is given")
    return args


def main(argv=None):
    args = parse_args(argv)
    import torch

    from detectorch_tpu_torch.checkpoint import caffe2_import as c2
    from detectorch_tpu_torch.checkpoint import store
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.config import PRESETS, SamplerConfig, SolverConfig, TestConfig
    from detectorch_tpu_torch.data import transforms as T
    from detectorch_tpu_torch.data.coco import roidb_for_training
    from detectorch_tpu_torch.models.detector import init_params
    from detectorch_tpu_torch.train.sampler import sample_rois
    from detectorch_tpu_torch.train.train_step import (
        load_state_dict,
        make_train_step,
        state_dict,
    )
    from detectorch_tpu_torch.utils.stats import TrainingStats

    device = torch.device(args.device)
    preset = "e2e_mask_rcnn_R-50-FPN_2x" if args.masks else "fast_rcnn_R-50-FPN_2x"
    cfg = PRESETS[preset].replace(arch=args.arch,
                                  roi_align_fwd_precision=args.roi_align_fwd_precision)
    solver = SolverConfig(base_lr=args.base_lr, max_iter=args.max_iter,
                          checkpoint_period=args.checkpoint_period)
    sampler_cfg = SamplerConfig(rois_per_image=args.rois_per_image)
    test_cfg = TestConfig(target_size=args.target_size, max_size=args.max_size)
    roi_align_impl = "pallas-slab" if args.roi_align == "auto" else args.roi_align
    init_state, make_step = make_train_step(
        cfg, solver, train_mask=args.masks, roi_align_impl=roi_align_impl,
        bwd_precision=args.roi_align_bwd_precision)

    print("loading roidb...", flush=True)
    _, roidb = roidb_for_training(args.ann, args.imdir, args.proposals)
    print(f"roidb: {len(roidb)} entries", flush=True)
    # the sampler puts foreground rows first, so the first fg-capacity rows
    # hold every possible mask-training roi
    fg_rows = int(np.round(sampler_cfg.fg_fraction * sampler_cfg.rois_per_image))
    mask_res = cfg.mask.resolution if args.masks else 0

    params = params_from_jax(init_params(cfg, seed=args.seed))
    if args.base_cnn:
        params.update(c2.import_base_cnn(c2.load_caffe2_pkl(args.base_cnn), cfg.arch))
        print("loaded base CNN weights", flush=True)
    params = params_to_device(params, device)
    state, optimizer = init_state(params)
    del params
    step_fn = make_step(optimizer)
    start_iter = 0
    if args.resume:
        latest = store.latest_checkpoint(args.out)
        if latest:
            state = load_state_dict(state, store.restore_checkpoint(latest, device))
            start_iter = state.step
            print(f"resumed from {latest} at iter {start_iter}", flush=True)

    batch_size = args.batch_size or 1
    blob_hw = tuple(args.blob)
    rng = np.random.RandomState(args.seed)
    stats = TrainingStats(args.max_iter, args.log_period)
    keys = ["image", "rois", "labels", "bbox_targets", "bbox_inside_weights",
            "bbox_outside_weights", "valid"]
    if args.masks:
        keys += ["mask_targets", "mask_valid"]

    def make_batch():
        batch = {k: [] for k in keys}
        for _ in range(batch_size):
            e = roidb[rng.randint(len(roidb))]
            im = T.load_image_rgb(e.file_path)
            if e.flipped:
                im = im[:, ::-1]
            image, scale, _ = T.preprocess_image(im, test_cfg.target_size, test_cfg.max_size,
                                                 buckets=(blob_hw,))
            blobs = sample_rois(e, scale, rng, sampler_cfg, cfg.num_classes,
                                mask_resolution=mask_res)
            blobs["image"] = image
            if args.masks:
                blobs["mask_targets"] = blobs["mask_targets"][:fg_rows]
                blobs["mask_valid"] = blobs["mask_valid"][:fg_rows]
            for k in keys:
                batch[k].append(blobs[k])
        return {k: torch.from_numpy(np.stack(v)).to(device) for k, v in batch.items()}

    loss_keys = ("loss", "loss_cls", "loss_bbox") + (("loss_mask",) if args.masks else ())
    for it in range(start_iter, args.max_iter):
        stats.iter_tic()
        state, metrics = step_fn(state, make_batch())
        losses = {k: float(metrics[k]) for k in loss_keys}
        stats.iter_toc()
        stats.update_iter_stats(it, losses, {"accuracy": float(metrics["accuracy"])})
        stats.log_iter_stats(it, metrics["lr"])
        if (it + 1) % args.checkpoint_period == 0 or (it + 1) == args.max_iter:
            path = store.save_checkpoint(args.out, it + 1, state_dict(state))
            print(f"saved {path}", flush=True)


if __name__ == "__main__":
    main()

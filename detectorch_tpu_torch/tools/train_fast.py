"""Fast, Faster, Mask and Keypoint R-CNN training, R-50-FPN and R-50-C4, in
PyTorch.

Port of ``tools/train_fast.py``: ``--fpn`` trains the FPN presets, without it
the C4 ones (``fast_rcnn_R-50-C4_2x``, ``e2e_faster_rcnn_R-50-C4_2x``,
``e2e_mask_rcnn_R-50-C4_2x``), and ``--keypoints`` trains
``e2e_keypoint_rcnn_R-50-FPN_1x`` (FPN implied) from a person-keypoints
dataset, as the JAX tool picks them. The Detectron 2x schedule
(SGD momentum 0.9, wd 1e-4, step-decay LR with linear warmup, grad clip
35, conv1 + res2 frozen), with the same argument names and defaults for the
options it keeps, ``ckpt-<step>`` checkpoints under --out and ``--resume``.

  * default: Fast R-CNN from precomputed proposals (``--masks``: Mask
    R-CNN, ``--keypoints``: Keypoint R-CNN, whose rois may come from the gt
    boxes alone);
  * ``--e2e``: end-to-end training, RPN and heads jointly, with anchor
    targets, roi sampling and (with ``--masks``) mask targets or (with
    ``--keypoints``) keypoint labels made inside the step from the gt boxes
    and keypoints (``train.e2e``); no proposal file;
  * ``--device-preprocess``: the uint8 schema, raw pixels and resize tables
    uploaded and resized on the device (``data.device_input``);
  * ``--prefetch N``: batches built by one producer thread behind an N-deep
    queue, in the same order and with the same draws as without it; the
    copy to the device stays on the main thread.

The roidb comes from ``data.coco.roidb_for_training``; images are read and
resized by ``data.transforms`` and masks rasterised by ``train.sampler``,
which use OpenCV (cv2).

  python -m detectorch_tpu_torch.tools.train_fast --fpn --e2e --masks \\
      --ann instances_train2014.json --imdir train2014 --out runs/mask_rcnn
  python -m detectorch_tpu_torch.tools.train_fast --e2e --masks \\
      --ann instances_train2014.json --imdir train2014 --out runs/mask_rcnn_c4

--base-cnn loads an ImageNet base CNN from a Detectron ``.pkl``
(``checkpoint.caffe2_import.import_base_cnn``); the heads keep their random
init. --roi-align takes JAX's names; the C4 presets take 'gather' (or
'auto'), as JAX's do: its Pallas names are the FPN path. --masks and
--keypoints together are refused, as JAX refuses them.
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
                   help="upload raw uint8 pixels and resize/normalise on the device "
                        "(flips applied to the uint8 pixels on the host)")
    p.add_argument("--target-size", type=int, default=800,
                   help="resize shorter side to this (reference 800)")
    p.add_argument("--max-size", type=int, default=1333,
                   help="cap longer side at this (reference 1333)")
    p.add_argument("--blob", type=int, nargs=2, default=(1344, 1344), metavar=("H", "W"),
                   help="fixed training blob bucket")
    p.add_argument("--rois-per-image", type=int, default=512)
    p.add_argument("--prefetch", type=int, default=0,
                   help="N > 0: build batches in a producer thread behind an N-deep "
                        "queue, overlapping host input preparation with the device; "
                        "0 = synchronous. Same draws either way (one producer)")
    p.add_argument("--roi-align", choices=["auto", "gather", "pallas", "pallas-mm", "pallas-slab"],
                   default="auto",
                   help="the JAX package's RoIAlign names; the port's RoIAlign is exact, so "
                        "every accepted name runs the same CUDA forward and backward "
                        "kernels ('pallas-mm' only at --roi-align-bwd-precision highest; "
                        "the C4 presets take 'gather')")
    p.add_argument("--roi-align-bwd-precision", choices=["bf16", "high", "highest"],
                   default="bf16", help="tier of 'pallas-mm'; only 'highest' is ported")
    p.add_argument("--roi-align-fwd-precision", choices=["exact", "bf16x3", "bf16"],
                   default="exact", help="only 'exact' is ported")
    p.add_argument("--keypoints", action="store_true",
                   help="train the Keypoint R-CNN preset (box branch + keypoint head) from "
                        "a person-keypoints dataset; --fpn is implied")
    p.add_argument("--masks", action="store_true",
                   help="train Mask R-CNN: box branch + mask head with "
                        "polys_to_mask_wrt_box targets")
    p.add_argument("--e2e", action="store_true",
                   help="end-to-end training: RPN and heads jointly, anchor targets, "
                        "roi sampling and mask targets or keypoint labels made inside the "
                        "step from the gts (no proposal file); composes with --masks or "
                        "--keypoints")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    args = p.parse_args(argv)
    if args.masks and args.keypoints:
        p.error("--masks and --keypoints are mutually exclusive")
    if args.base_cnn and not os.path.isfile(args.base_cnn):
        p.error(f"--base-cnn {args.base_cnn}: no such file")
    if not (args.fpn or args.keypoints) and args.roi_align not in ("auto", "gather"):
        p.error(f"--roi-align {args.roi_align} is the FPN path: the C4 presets "
                "(no --fpn) take 'gather'")
    if not args.masks and not args.keypoints and not args.e2e and not args.proposals:
        # Fast R-CNN needs hard negatives from precomputed proposals
        p.error("--proposals is required unless --masks, --keypoints or --e2e is given")
    return args


def main(argv=None):
    args = parse_args(argv)
    import torch

    from detectorch_tpu_torch.checkpoint import caffe2_import as c2
    from detectorch_tpu_torch.checkpoint import store
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
    from detectorch_tpu_torch.config import PRESETS, SamplerConfig, SolverConfig, TestConfig
    from detectorch_tpu_torch.data.coco import roidb_for_training
    from detectorch_tpu_torch.models.detector import init_params
    from detectorch_tpu_torch.train.train_step import (
        load_state_dict,
        make_train_step,
        state_dict,
    )
    from detectorch_tpu_torch.utils.stats import TrainingStats

    device = torch.device(args.device)
    if args.keypoints:
        preset = "e2e_keypoint_rcnn_R-50-FPN_1x"
    else:
        family = "FPN" if args.fpn else "C4"
        kind = "e2e_mask_rcnn" if args.masks else "e2e_faster_rcnn" if args.e2e else "fast_rcnn"
        preset = f"{kind}_R-50-{family}_2x"
    cfg = PRESETS[preset].replace(arch=args.arch,
                                  roi_align_fwd_precision=args.roi_align_fwd_precision)
    solver = SolverConfig(base_lr=args.base_lr, max_iter=args.max_iter,
                          checkpoint_period=args.checkpoint_period)
    sampler_cfg = SamplerConfig(rois_per_image=args.rois_per_image)
    test_cfg = TestConfig(target_size=args.target_size, max_size=args.max_size)
    if args.roi_align == "auto":
        roi_align_impl = "pallas-slab" if cfg.use_fpn else "gather"
    else:
        roi_align_impl = args.roi_align
    blob_hw = tuple(args.blob)
    kwargs = dict(train_mask=args.masks, device_input=args.device_preprocess, blob_hw=blob_hw,
                  roi_align_impl=roi_align_impl, bwd_precision=args.roi_align_bwd_precision)
    if args.e2e:
        from detectorch_tpu_torch.train.e2e import make_e2e_train_step

        init_state, make_step = make_e2e_train_step(cfg, solver, sampler_cfg, seed=args.seed,
                                                    train_keypoints=args.keypoints, **kwargs)
    else:
        init_state, make_step = make_train_step(cfg, solver, **kwargs)

    print("loading roidb...", flush=True)
    _, roidb = roidb_for_training(args.ann, args.imdir, args.proposals,
                                  require_keypoints=args.keypoints)
    print(f"roidb: {len(roidb)} entries", flush=True)

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

    make_batch_np = BatchMaker(args, cfg, sampler_cfg, test_cfg, roidb)

    def put_batch(np_batch):
        # the copy to the device stays on the main thread
        return {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()}

    if args.prefetch > 0:
        import queue
        import threading

        batches: "queue.Queue" = queue.Queue(maxsize=args.prefetch)

        def produce():
            while True:
                batches.put(make_batch_np())

        threading.Thread(target=produce, daemon=True).start()

        def next_batch():
            return put_batch(batches.get())
    else:
        def next_batch():
            return put_batch(make_batch_np())

    stats = TrainingStats(args.max_iter, args.log_period)
    loss_keys = ("loss", "loss_cls", "loss_bbox") + (("loss_kps",) if args.keypoints else ()) \
        + (("loss_mask",) if args.masks else ()) \
        + (("loss_rpn_cls", "loss_rpn_bbox") if args.e2e else ())
    for it in range(start_iter, args.max_iter):
        stats.iter_tic()
        state, metrics = step_fn(state, next_batch())
        losses = {k: float(metrics[k]) for k in loss_keys}
        stats.iter_toc()
        stats.update_iter_stats(it, losses, {"accuracy": float(metrics["accuracy"])})
        stats.log_iter_stats(it, metrics["lr"])
        if (it + 1) % args.checkpoint_period == 0 or (it + 1) == args.max_iter:
            path = store.save_checkpoint(args.out, it + 1, state_dict(state))
            print(f"saved {path}", flush=True)


# one fixed gt capacity per image, as the JAX trainer's (COCO has at most ~93)
GT_PAD = 128


class BatchMaker:
    """Makes one numpy training batch per call, on any one thread: images
    drawn from the roidb with the trainer's RandomState, read, flipped,
    and resized on the host or packed for ``--device-preprocess``; then the
    host-sampled rois with their mask targets or keypoint labels (Fast,
    Mask, Keypoint R-CNN) or the padded gt boxes, classes, mask rasters and
    keypoints (``--e2e``; crowd gts dropped)."""

    def __init__(self, args, cfg, sampler_cfg, test_cfg, roidb):
        from detectorch_tpu_torch.data.device_input import RAW_STRIDE

        self.args, self.cfg, self.sampler_cfg, self.test_cfg = args, cfg, sampler_cfg, test_cfg
        self.roidb = roidb
        self.rng = np.random.RandomState(args.seed)
        self.blob_hw = tuple(args.blob)
        self.batch_size = args.batch_size or 1
        # the sampler puts foreground rows first, so the first fg-capacity
        # rows hold every possible mask- or keypoint-training roi
        self.fg_rows = int(np.round(sampler_cfg.fg_fraction * sampler_cfg.rois_per_image))
        # one raw bucket: the largest original image, padded to RAW_STRIDE
        self.raw_hw = (max(-(-e.height // RAW_STRIDE) * RAW_STRIDE for e in roidb),
                       max(-(-e.width // RAW_STRIDE) * RAW_STRIDE for e in roidb))

    def __call__(self):
        batch = {}
        for _ in range(self.batch_size):
            e = self.roidb[self.rng.randint(len(self.roidb))]
            for k, v in self._one(e).items():
                batch.setdefault(k, []).append(v)
        return {k: np.stack(v) for k, v in batch.items()}

    def _one(self, e):
        from detectorch_tpu_torch.data import transforms as T
        from detectorch_tpu_torch.data.device_input import pack_tables_meta, prepare_raw
        from detectorch_tpu_torch.train.sampler import sample_rois

        args, tcfg = self.args, self.test_cfg
        im = T.load_image_rgb(e.file_path)
        if e.flipped:
            # flip the uint8 pixels before the resize, like the reference; the
            # flipped roidb entry's boxes and polygons are flipped already
            im = np.ascontiguousarray(im[:, ::-1])
        out = {}
        if args.device_preprocess:
            raw, m = prepare_raw(im.astype(np.uint8), tcfg.target_size, tcfg.max_size,
                                 buckets=(self.blob_hw,))
            out["raw"] = np.zeros(self.raw_hw + (3,), np.uint8)
            out["raw"][: raw.shape[0], : raw.shape[1]] = raw
            out["tables"], out["meta"] = pack_tables_meta(m)
            scale = m["scale"]
        else:
            out["image"], scale, _ = T.preprocess_image(im, tcfg.target_size, tcfg.max_size,
                                                        buckets=(self.blob_hw,))
        if args.e2e:
            if not args.device_preprocess:
                out["info"] = np.asarray([round(e.height * scale), round(e.width * scale),
                                          scale], np.float32)
            out.update(self._gts(e, scale))
            return out
        mask_res = self.cfg.mask.resolution if args.masks else 0
        heatmap = self.cfg.keypoint.heatmap_size if self.cfg.keypoint else 56
        blobs = sample_rois(e, scale, self.rng, self.sampler_cfg, self.cfg.num_classes,
                            compact_targets=args.device_preprocess,
                            keypoint_heatmap_size=heatmap, mask_resolution=mask_res)
        keys = ["rois", "labels", "valid"] + (
            ["bbox_targets_compact"] if args.device_preprocess
            else ["bbox_targets", "bbox_inside_weights", "bbox_outside_weights"])
        out.update({k: blobs[k] for k in keys})
        if args.keypoints:
            out["kp_labels"] = blobs["kp_labels"][: self.fg_rows]
            out["kp_valid"] = blobs["kp_valid"][: self.fg_rows]
        if args.masks:
            out["mask_targets"] = blobs["mask_targets"][: self.fg_rows]
            out["mask_valid"] = blobs["mask_valid"][: self.fg_rows]
        return out

    def _gts(self, e, scale):
        """Padded gts of one image; with --masks one raster per gt, wrt its
        own box (the step crop-resizes it into each sampled roi's frame);
        with --keypoints each gt's keypoints, x and y scaled as its box."""
        from detectorch_tpu_torch.train.e2e import GT_RASTER_RES
        from detectorch_tpu_torch.train.sampler import polys_to_mask_wrt_box

        # crowd regions are never positive targets (upstream roi_data/rpn.py)
        gi = np.where((e.gt_classes > 0) & (e.is_crowd == 0))[0][:GT_PAD]
        out = {"gt_boxes": np.zeros((GT_PAD, 4), np.float32),
               "gt_classes": np.zeros(GT_PAD, np.int32), "gt_valid": np.zeros(GT_PAD, bool)}
        out["gt_boxes"][: len(gi)] = e.boxes[gi] * scale
        out["gt_classes"][: len(gi)] = e.gt_classes[gi]
        out["gt_valid"][: len(gi)] = True
        if self.args.masks:
            out["gt_masks"] = np.zeros((GT_PAD, GT_RASTER_RES, GT_RASTER_RES), np.uint8)
            out["gt_mask_valid"] = np.zeros(GT_PAD, bool)
            for i, ind in enumerate(gi):
                segm = e.segms[ind] if ind < len(e.segms) else None
                if isinstance(segm, list) and segm:
                    out["gt_masks"][i] = polys_to_mask_wrt_box(segm, e.boxes[ind], GT_RASTER_RES)
                    out["gt_mask_valid"][i] = True
        if self.args.keypoints:
            p = (e.gt_keypoints.shape[1] if e.gt_keypoints is not None
                 else self.cfg.keypoint.num_keypoints)
            out["gt_keypoints"] = np.zeros((GT_PAD, p, 3), np.float32)
            if e.gt_keypoints is not None and len(e.gt_keypoints):
                kk = e.gt_keypoints[np.maximum(e.box_to_gt_ind_map[gi], 0)]
                out["gt_keypoints"][: len(gi), :, :2] = kk[:, :, :2] * scale
                out["gt_keypoints"][: len(gi), :, 2] = kk[:, :, 2]
        return out


if __name__ == "__main__":
    main()

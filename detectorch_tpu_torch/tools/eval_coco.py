"""COCO evaluation of the R-50-FPN and R-50-C4 families and Keypoint R-CNN,
in PyTorch.

Port of ``tools/eval_coco.py``: runs a preset over a COCO dataset and
prints throughput and box (and mask, or keypoint) AP, through
``eval.engine.evaluate_dataset``.

  python -m detectorch_tpu_torch.tools.eval_coco --preset e2e_mask_rcnn_R-50-FPN_2x \\
      --weights model_final.pkl --ann instances_minival2014.json --imdir val2014 \\
      [--proposals proposals.pkl] [--limit 100] [--batch 8 --device-preprocess]

Weights come from a Detectron ``.pkl`` (--weights) or from a ``ckpt-<step>``
of the port's trainer (--ckpt: a checkpoint, or a run directory whose latest
checkpoint is read); BN is folded into the convs either way. Every preset
runs: Fast, Faster and Mask R-CNN (FPN and C4) and Keypoint R-CNN
(``e2e_keypoint_rcnn_R-50-FPN_1x``, scored by OKS on a person-keypoints
annotation file).
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", required=True)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="Detectron .pkl checkpoint")
    src.add_argument("--ckpt", help="a ckpt-<step> of the port's trainer, or its run "
                                    "directory (the latest checkpoint is read)")
    p.add_argument("--ann", required=True)
    p.add_argument("--imdir", required=True)
    p.add_argument("--proposals", default=None,
                   help="proposal .pkl (required for fast_rcnn presets)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--out", default=None, help="write results json here")
    p.add_argument("--output-dir", default=None,
                   help="write COCO-format results jsons + evaluator pkls here")
    p.add_argument("--per-class-ap", action="store_true",
                   help="print the per-category AP table")
    p.add_argument("--fp32", action="store_true", help="fp32 backbone compute")
    p.add_argument("--roi-align-fwd", default=None, choices=["exact"],
                   help="RoIAlign forward tier; the port's RoIAlign is exact")
    p.add_argument("--exact-blob", action="store_true",
                   help="reference-exact ceil-32 image padding instead of the buckets")
    p.add_argument("--device-preprocess", action="store_true",
                   help="upload raw uint8 and resize/normalize on the device")
    p.add_argument("--batch", type=int, default=1,
                   help="bucket-grouped batched inference (throughput mode)")
    p.add_argument("--target-sizes", default=None,
                   help="comma-separated test scales, e.g. 480,576,688,800: more than one "
                        "switches to multi-scale inference (single-image engine)")
    p.add_argument("--device", default="cuda", help="torch device to run on")
    return p.parse_args(argv)


def load_params(args, cfg):
    """Port-layout params with BN folded, from --weights or --ckpt."""
    from detectorch_tpu_torch.checkpoint import caffe2_import as c2

    if args.ckpt:
        from detectorch_tpu_torch.checkpoint import store

        path = store.latest_checkpoint(args.ckpt) or args.ckpt
        print(f"loading checkpoint {path}", flush=True)
        return c2.fold_bn(store.restore_checkpoint(path, map_location="cpu")["params"])
    print(f"loading weights {args.weights}", flush=True)
    return c2.fold_bn(c2.import_params(c2.load_caffe2_pkl(args.weights), cfg))


def main(argv=None):
    args = parse_args(argv)
    from detectorch_tpu_torch.config import PRESETS, TestConfig
    from detectorch_tpu_torch.data.coco import CocoDataset
    from detectorch_tpu_torch.eval.engine import evaluate_dataset

    cfg = PRESETS[args.preset]
    if args.fp32:
        cfg = cfg.replace(compute_dtype="float32")
    if args.roi_align_fwd:
        cfg = cfg.replace(roi_align_fwd_precision=args.roi_align_fwd)
    test_cfg = TestConfig(exact_blob_dims=args.exact_blob,
                          device_preprocess=args.device_preprocess)
    params = load_params(args, cfg)

    ds = CocoDataset(args.ann, args.imdir)
    roidb = ds.get_roidb(gt=False, proposal_file=args.proposals if not cfg.use_rpn else None)
    sizes = [int(s) for s in args.target_sizes.split(",")] if args.target_sizes else None
    # evaluate_dataset folds a 1-element list into test_cfg.target_size
    bbox_stats, segm_stats, info = evaluate_dataset(
        cfg, test_cfg, params, ds, roidb=roidb, limit=args.limit, batch_size=args.batch,
        output_dir=args.output_dir,
        dataset_name=os.path.splitext(os.path.basename(args.ann))[0],
        per_class_ap=args.per_class_ap, target_sizes=sizes, device=args.device)
    print(f"throughput: {info['images_per_sec']:.2f} images/sec on {args.device}", flush=True)
    if bbox_stats is not None:
        print(f"box AP: {bbox_stats[0] * 100:.1f}")
    if segm_stats is not None:
        print(f"mask AP: {segm_stats[0] * 100:.1f}")
    if info["keypoints_stats"] is not None:
        print(f"keypoint AP: {info['keypoints_stats'][0] * 100:.1f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"bbox": info["bbox"], "segm": info["segm"],
                       "keypoints": info["keypoints"]}, f)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

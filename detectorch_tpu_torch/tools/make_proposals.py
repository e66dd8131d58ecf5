"""Write a precomputed-proposals .pkl with the port's RPN.

Port of ``tools/make_proposals.py`` (Detectron's ``tools/rpn_generate.py``
workflow): runs an RPN preset over a COCO dataset through
``eval.engine.InferenceEngine`` and writes ``{"boxes": [per-image (N, 4)
xyxy float32, original-image coordinates, score order, clipped to the
image], "ids": [image ids]}``, the schema that ``data.coco`` reads as a
proposal file (``roidb_for_training(..., proposal_file)``, ``--proposals``
of the trainer and of ``eval_coco``). Close the loop with::

  python -m detectorch_tpu_torch.tools.make_proposals \\
      --preset e2e_faster_rcnn_R-50-FPN_2x --weights model.pkl \\
      --ann instances_train2014.json --imdir train2014 --out proposals.pkl
  python -m detectorch_tpu_torch.tools.train_fast --fpn --proposals proposals.pkl ...

The flags are the JAX tool's, except that ``--ckpt`` (a ``ckpt-<step>`` of
the port's trainer, or its run directory) replaces ``--orbax``, as in
``eval_coco``, and ``--device`` (default cuda) picks the torch device.
"""

from __future__ import annotations

import argparse
import pickle


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="e2e_faster_rcnn_R-50-FPN_2x")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="Detectron .pkl checkpoint")
    src.add_argument("--ckpt", help="a ckpt-<step> of the port's trainer, or its run "
                                    "directory (the latest checkpoint is read)")
    p.add_argument("--ann", required=True)
    p.add_argument("--imdir", required=True)
    p.add_argument("--out", required=True, help="output proposals .pkl")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--fp32", action="store_true", help="fp32 backbone compute")
    p.add_argument("--device", default="cuda", help="torch device to run on")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from detectorch_tpu_torch.config import PRESETS, TestConfig
    from detectorch_tpu_torch.data import transforms as T
    from detectorch_tpu_torch.data.coco import CocoDataset
    from detectorch_tpu_torch.data.loader import PrefetchLoader
    from detectorch_tpu_torch.eval.engine import InferenceEngine
    from detectorch_tpu_torch.tools.eval_coco import load_params

    cfg = PRESETS[args.preset]
    if not cfg.use_rpn:
        raise SystemExit(f"{args.preset}: proposal generation needs an RPN preset")
    if args.fp32:
        cfg = cfg.replace(compute_dtype="float32")
    engine = InferenceEngine(cfg, TestConfig(), load_params(args, cfg), device=args.device)
    roidb = CocoDataset(args.ann, args.imdir).get_roidb(gt=False)
    if args.limit:
        roidb = roidb[: args.limit]

    def make_sample(entry):
        sample_args, _, _ = engine.preprocess(T.load_image_rgb(entry.file_path))
        return entry, sample_args

    boxes_list, ids = [], []
    for i, (entry, sample_args) in enumerate(PrefetchLoader(roidb, make_sample, num_workers=4,
                                                            prefetch=8)):
        # the box branch's rois ARE the RPN's proposals, in the collect's
        # score order
        out = engine.submit(sample_args)
        rois = out.rois[0].cpu().numpy().astype(np.float32) / engine._scale_of(sample_args)
        rois = rois[out.roi_valid[0].cpu().numpy()]
        rois[:, [0, 2]] = np.clip(rois[:, [0, 2]], 0, entry.width - 1)
        rois[:, [1, 3]] = np.clip(rois[:, [1, 3]], 0, entry.height - 1)
        boxes_list.append(rois)
        ids.append(int(entry.image_id))
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{len(roidb)}", flush=True)

    with open(args.out, "wb") as f:
        pickle.dump({"boxes": boxes_list, "ids": ids}, f)
    n = [len(b) for b in boxes_list]
    print(f"wrote {args.out}: {len(ids)} images, {min(n)}-{max(n)} proposals/image",
          flush=True)


if __name__ == "__main__":
    main()

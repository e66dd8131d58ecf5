"""Single-image demo (rebuild of reference demo.ipynb / demo_FPN.ipynb), in
PyTorch.

Port of ``tools/demo.py``: runs a model preset on an image and writes a
visualisation, through ``eval.engine.InferenceEngine.run_image`` (on a card,
the RoIAlign forward kernel: the box call, then the mask or keypoint call)
and ``utils.vis``.

  python -m detectorch_tpu_torch.tools.demo --image demo.jpg \\
      --preset e2e_mask_rcnn_R-50-FPN_2x [--weights model_final.pkl] \\
      --out out.jpg [--device cpu]

Without --weights, random parameters are used (pipeline smoke only).
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image", required=True)
    p.add_argument("--preset", default="e2e_mask_rcnn_R-50-FPN_2x")
    p.add_argument("--weights", default=None)
    p.add_argument("--out", default="demo_out.jpg")
    p.add_argument("--thresh", type=float, default=0.7)
    p.add_argument("--backend", choices=["cv2", "matplotlib"], default="cv2",
                   help="matplotlib renders polygonised masks and supports "
                        "pdf output like the reference's vis_one_image")
    p.add_argument("--device", default="cuda", help="torch device to run on")
    return p.parse_args(argv)


def run_demo(cfg, test_cfg, params, image: str, out: str, thresh: float = 0.7,
             backend: str = "cv2", device="cuda"):
    """Run `cfg` with port-layout `params` on the image file `image` and
    write its visualisation to `out` (the matplotlib backend saves
    ``<stem>.<ext>`` beside it, pdf without an extension). Returns the
    engine's result dict."""
    from detectorch_tpu_torch.data.transforms import load_image_rgb
    from detectorch_tpu_torch.eval.engine import InferenceEngine
    from detectorch_tpu_torch.utils.vis import vis_one_image, vis_one_image_matplotlib

    engine = InferenceEngine(cfg, test_cfg, params, device)
    im = load_image_rgb(image)
    print("running inference...", flush=True)
    res = engine.run_image(im)
    n = (res["scores"] >= thresh).sum()
    print(f"{len(res['scores'])} detections ({n} above {thresh})", flush=True)
    if backend == "matplotlib":
        stem, ext = os.path.splitext(out)
        saved = vis_one_image_matplotlib(
            im, res["boxes"], res["scores"], res["classes"],
            res.get("rles"), res.get("keypoints"), thresh=thresh,
            output_dir=os.path.dirname(out) or ".",
            im_name=os.path.basename(stem), ext=(ext.lstrip(".") or "pdf"),
        )
        print(f"wrote {saved}")
    else:
        vis_one_image(
            im, res["boxes"], res["scores"], res["classes"],
            res.get("rles"), res.get("keypoints"),
            thresh=thresh, output_path=out,
        )
        print(f"wrote {out}")
    return res


def main(argv=None):
    args = parse_args(argv)
    from detectorch_tpu_torch.checkpoint import caffe2_import as c2
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax
    from detectorch_tpu_torch.config import PRESETS, TestConfig
    from detectorch_tpu_torch.models.detector import init_params

    cfg = PRESETS[args.preset]
    if not cfg.use_rpn:
        raise SystemExit("demo requires an RPN preset (no proposal file input)")
    if args.weights:
        params = c2.fold_bn(c2.import_params(c2.load_caffe2_pkl(args.weights), cfg))
    else:
        print("WARNING: random weights (smoke mode)", flush=True)
        params = params_from_jax(init_params(cfg, seed=0))
    return run_demo(cfg, TestConfig(), params, args.image, args.out, args.thresh,
                    args.backend, args.device)


if __name__ == "__main__":
    main()

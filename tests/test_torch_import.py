"""The port stands alone, and chip_smoke.py refuses to run without a card.

The machine with the card has neither JAX nor the JAX package, so importing
or running the port must pull in neither: not ``jax``, and no module of
``detectorch_tpu``. conftest.py has already imported both into this
process, so the checks run in a fresh interpreter.
"""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import detectorch_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(args, cwd, timeout=300, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


# printed and checked by every fresh-interpreter run below
LEAK_CHECK = """
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "detectorch_tpu"))
print("LEAKED", leaked)
sys.exit(1 if leaked else 0)
"""


def _port_modules():
    return ["detectorch_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(detectorch_tpu_torch.__path__,
                                              "detectorch_tpu_torch.")]


def test_port_imports_without_jax():
    mods = _port_modules()
    assert "detectorch_tpu_torch.ops.cuda.roi_align_kernel" in mods
    assert "detectorch_tpu_torch.train.train_step" in mods
    assert "detectorch_tpu_torch.tools.train_fast" in mods
    assert "detectorch_tpu_torch.eval.engine" in mods
    assert "detectorch_tpu_torch.tools.eval_coco" in mods
    assert "detectorch_tpu_torch.train.e2e" in mods
    assert "detectorch_tpu_torch.tools.make_proposals" in mods
    assert "detectorch_tpu_torch.ops.keypoints" in mods
    assert "detectorch_tpu_torch.data.synth" in mods
    for m in ("parallel.mesh", "parallel.launch", "parallel.dryrun", "tools.dryrun_multichip",
              "tools.multicard_check", "tools.demo", "eval.rle_native", "utils.vis",
              "utils.colormap", "utils.io", "utils.selective_search", "utils.debug",
              "utils.profiling", "tools.probe_weights", "tools.production_ap",
              "tools.measure", "tools.bench", "tools.bench_e2e", "tools.profile_e2e_train",
              "tools.profile_stages", "tools.profile_mfu"):
        assert f"detectorch_tpu_torch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n" + LEAK_CHECK)
    proc = _python(["-c", code], cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_training_data_path_runs_without_jax():
    # roidb entries built in memory, the port's bbox targets and sampler,
    # once with the targets set and once computing them itself
    code = """
import copy, sys
import numpy as np
from detectorch_tpu_torch.config import SamplerConfig
from detectorch_tpu_torch.data.coco import RoidbEntry, add_bbox_regression_targets
from detectorch_tpu_torch.train.sampler import sample_rois

rng = np.random.RandomState(0)
gt = np.array([[10, 10, 60, 60], [70, 30, 120, 100]], np.float32)
props = np.concatenate([gt[[0, 1] * 4] + rng.randn(8, 4).astype(np.float32) * 4,
                        rng.uniform(0, 100, (30, 4)).astype(np.float32)])
props[:, 2:] = np.maximum(props[:, 2:], props[:, :2] + 4)
boxes = np.concatenate([gt, props])
ov = np.zeros((len(boxes), 81), np.float32)
ov[:2, [3, 7]] = np.eye(2)
ov[2:10, 3] = 0.7
entry = RoidbEntry(
    image_id=1, file_path="unused.jpg", height=120, width=160, boxes=boxes,
    gt_classes=np.array([3, 7] + [0] * len(props), np.int32),
    is_crowd=np.zeros(len(boxes), np.uint8), max_overlaps=ov.max(1),
    max_classes=ov.argmax(1).astype(np.int32),
    box_to_gt_ind_map=np.array([0, 1] + [0] * 8 + [-1] * 30, np.int32))
bare = copy.deepcopy(entry)
add_bbox_regression_targets([entry])
assert entry.bbox_targets.shape == (len(boxes), 5) and entry.bbox_targets[2:10, 0].all()
for e in (entry, bare):
    blobs = sample_rois(e, 1.5, np.random.RandomState(1), SamplerConfig(rois_per_image=16))
    assert blobs["valid"].sum() > 0 and blobs["bbox_inside_weights"].sum() > 0
""" + LEAK_CHECK
    proc = _python(["-c", code], cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_eval_path_runs_without_jax(tmp_path):
    # in-memory uint8 images through load_image, device_preprocess, the
    # batched engine, the COCO conversion and COCOeval, a caffe2 pkl in
    # between: the eval path of chip_smoke.py's phase 9, tiny and on the CPU
    code = """
import json, os, sys
import numpy as np
from detectorch_tpu_torch.config import PRESETS, RPNConfig, TestConfig
from detectorch_tpu_torch.data.coco import CocoDataset
from detectorch_tpu_torch.eval import rle
from detectorch_tpu_torch.checkpoint import caffe2_import as c2
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.eval.engine import evaluate_dataset
from detectorch_tpu_torch.models.detector import init_params

rng = np.random.RandomState(0)
images, anns, imgs = {}, [], []
for i in range(3):
    h, w = (48, 64) if i < 2 else (64, 48)
    images[f"im{i}.png"] = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    m = np.zeros((h, w), np.uint8)
    m[8:30, 10:40] = 1
    imgs.append({"id": i + 1, "file_name": f"im{i}.png", "height": h, "width": w})
    anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1, "bbox": [10, 8, 30, 22],
                 "area": 660.0, "iscrowd": 0, "segmentation": rle.encode(m)})
tmp = sys.argv[1]
with open(os.path.join(tmp, "ann.json"), "w") as f:
    json.dump({"images": imgs, "annotations": anns,
               "categories": [{"id": c, "name": str(c)} for c in range(1, 81)]}, f)
cfg = PRESETS["e2e_mask_rcnn_R-50-FPN_2x"].replace(
    compute_dtype="float32", rpn=RPNConfig(pre_nms_top_n=60, post_nms_top_n=16))
c2.save_caffe2_pkl(params_from_jax(init_params(cfg, seed=0)), cfg, os.path.join(tmp, "m.pkl"))
params = c2.fold_bn(c2.import_params(c2.load_caffe2_pkl(os.path.join(tmp, "m.pkl")), cfg))
tcfg = TestConfig(target_size=48, max_size=64, detections_per_img=4, score_thresh=0.0,
                  exact_blob_dims=True, device_preprocess=True)
bbox, segm, info = evaluate_dataset(
    cfg, tcfg, params, CocoDataset(os.path.join(tmp, "ann.json"), tmp), verbose=False,
    batch_size=2, load_image=lambda p: images[os.path.basename(p)], device="cpu")
assert len(bbox) == len(segm) == 12 and len(info["segm"]) == 12, (bbox, segm)
""" + LEAK_CHECK
    # the Tier-1 command's six workers share the cores: one torch thread
    proc = _python(["-c", code, str(tmp_path)], cwd=REPO,
                   env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_e2e_training_and_proposals_run_without_jax(tmp_path):
    # the e2e trainer's data path (uint8 input, gt rasters, a producer
    # thread) for one iteration, then make_proposals on a Detectron pkl
    # written by the port, on a synthetic COCO set made here
    from detectorch_tpu.data.synth import build_synth_coco

    ann, imdir = build_synth_coco(str(tmp_path / "ds"), n_images=2, height=96, width=128,
                                  seed=13)
    code = """
import dataclasses, os, sys
import detectorch_tpu_torch.config as config
from detectorch_tpu_torch.checkpoint import caffe2_import as c2
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.models.detector import init_params
from detectorch_tpu_torch.tools import make_proposals, train_fast

ann, imdir, tmp = sys.argv[1:4]
train_fast.main(["--ann", ann, "--imdir", imdir, "--fpn", "--e2e", "--masks",
                 "--device-preprocess", "--prefetch", "2", "--out", os.path.join(tmp, "run"),
                 "--max-iter", "1", "--target-size", "96", "--max-size", "128",
                 "--blob", "96", "128", "--rois-per-image", "16", "--device", "cpu"])
assert os.path.exists(os.path.join(tmp, "run", "ckpt-1"))
preset = "e2e_faster_rcnn_R-50-FPN_2x"
cfg = config.PRESETS[preset]
config.PRESETS[preset] = cfg.replace(
    rpn=dataclasses.replace(cfg.rpn, pre_nms_top_n=300, post_nms_top_n=64))
small = config.TestConfig
config.TestConfig = lambda: small(target_size=96, max_size=128, exact_blob_dims=True)
c2.save_caffe2_pkl(params_from_jax(init_params(cfg, seed=0)), cfg, os.path.join(tmp, "m.pkl"))
make_proposals.main(["--preset", preset, "--weights", os.path.join(tmp, "m.pkl"),
                     "--ann", ann, "--imdir", imdir, "--out", os.path.join(tmp, "p.pkl"),
                     "--fp32", "--device", "cpu"])
assert os.path.exists(os.path.join(tmp, "p.pkl"))
""" + LEAK_CHECK
    # the Tier-1 command's six workers share the cores: one torch thread
    proc = _python(["-c", code, ann, imdir, str(tmp_path)], cwd=REPO,
                   env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_c4_paths_run_without_jax(tmp_path):
    # the C4 family tiny and on the CPU: Faster and Fast R-CNN inference,
    # make_mask_fn, evaluate_dataset from in-memory images, the
    # host-sampled training step with masks and the e2e step
    code = """
import json, os, sys
import numpy as np
import torch
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.config import PRESETS, RPNConfig, SamplerConfig, TestConfig
from detectorch_tpu_torch.data.coco import CocoDataset
from detectorch_tpu_torch.eval.engine import evaluate_dataset
from detectorch_tpu_torch.models.detector import init_params, make_inference_fn, make_mask_fn
from detectorch_tpu_torch.train.e2e import make_e2e_train_step
from detectorch_tpu_torch.train.train_step import make_train_step

cfg = PRESETS["e2e_mask_rcnn_R-50-C4_2x"].replace(compute_dtype="float32",
                                                  rpn=RPNConfig(pre_nms_top_n=60, post_nms_top_n=8))
params = params_from_jax(init_params(cfg, seed=0))
tcfg = TestConfig(target_size=48, max_size=64, detections_per_img=4, score_thresh=0.0,
                  exact_blob_dims=True, max_proposals=8)
rng = np.random.RandomState(0)
images = torch.from_numpy(rng.randn(1, 64, 64, 3).astype(np.float32))
meta = [torch.ones(1), torch.full((1,), 64.0), torch.full((1,), 64.0)]
out = make_inference_fn(cfg, tcfg)(params, images, *meta)
assert out.masks.shape == (1, 12, 14, 14)
masks = make_mask_fn(cfg)(params, images, *meta, out.detections.boxes, out.detections.classes)
assert masks.shape == (1, 12, 14, 14)
fast = PRESETS["fast_rcnn_R-50-C4_2x"].replace(compute_dtype="float32")
fout = make_inference_fn(fast, tcfg)(params, images, *meta,
                                     torch.tensor([[[4.0, 4.0, 40.0, 30.0]] * 8]))
assert fout.cls_scores.shape == (1, 8, 81)

tmp = sys.argv[1]
pics = {"im0.png": rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)}
with open(os.path.join(tmp, "ann.json"), "w") as f:
    json.dump({"images": [{"id": 1, "file_name": "im0.png", "height": 48, "width": 64}],
               "annotations": [{"id": 1, "image_id": 1, "category_id": 1,
                                "bbox": [10, 8, 30, 22], "area": 660.0, "iscrowd": 0,
                                "segmentation": [[10, 8, 40, 8, 40, 30, 10, 30]]}],
               "categories": [{"id": c, "name": str(c)} for c in range(1, 81)]}, f)
bbox, segm, info = evaluate_dataset(
    cfg, tcfg.replace(device_preprocess=True), params,
    CocoDataset(os.path.join(tmp, "ann.json"), tmp), verbose=False, batch_size=1,
    load_image=lambda p: pics[os.path.basename(p)], device="cpu")
assert len(info["segm"]) == len(info["bbox"]) > 0

b, r = 1, 8
rois = torch.tensor([[[4.0, 4.0, 40.0, 30.0]] * r])
batch = {"image": images, "rois": rois, "labels": torch.tensor([[3] + [0] * (r - 1)]),
         "bbox_targets": torch.zeros(b, r, 324), "bbox_inside_weights": torch.zeros(b, r, 324),
         "bbox_outside_weights": torch.zeros(b, r, 324), "valid": torch.ones(b, r, dtype=bool),
         "mask_targets": torch.ones(b, 2, 14, 14), "mask_valid": torch.tensor([[True, False]])}
init_state, make_step = make_train_step(cfg, train_mask=True)
state, opt = init_state(params)
state, metrics = make_step(opt)(state, batch)
assert torch.isfinite(metrics["loss"])
e2e = {"image": images, "info": torch.tensor([[64.0, 64.0, 1.0]]),
       "gt_boxes": torch.tensor([[[8.0, 8.0, 40.0, 36.0]]]), "gt_classes": torch.tensor([[3]]),
       "gt_valid": torch.tensor([[True]])}
init_state, make_step = make_e2e_train_step(cfg, sampler_cfg=SamplerConfig(rois_per_image=8),
                                            train_pre_nms=60, train_post_nms=8)
state, opt = init_state(params)
state, metrics = make_step(opt)(state, e2e)
assert torch.isfinite(metrics["loss_rpn_cls"])
""" + LEAK_CHECK
    # the Tier-1 command's six workers share the cores: one torch thread
    proc = _python(["-c", code, str(tmp_path)], cwd=REPO,
                   env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_keypoint_paths_run_without_jax(tmp_path):
    # Keypoint R-CNN tiny and on the CPU (a small head): a person-keypoints
    # set made by the port's data/synth copy, inference and make_keypoint_fn,
    # evaluate_dataset with its OKS stats, the host-sampled step with
    # keypoint labels, and train_fast --keypoints --e2e for one iteration
    code = """
import dataclasses, os, sys
import numpy as np
import torch
import detectorch_tpu_torch.config as config
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.data.coco import CocoDataset
from detectorch_tpu_torch.data.synth import build_synth_coco
from detectorch_tpu_torch.eval.engine import evaluate_dataset
from detectorch_tpu_torch.models.detector import init_params, make_inference_fn, make_keypoint_fn
from detectorch_tpu_torch.tools import train_fast
from detectorch_tpu_torch.train.train_step import make_train_step

tmp = sys.argv[1]
ann, imdir = build_synth_coco(os.path.join(tmp, "ds"), n_images=2, height=64, width=96, seed=2,
                              with_keypoints=True)
preset = "e2e_keypoint_rcnn_R-50-FPN_1x"
cfg = config.PRESETS[preset].replace(rpn=config.RPNConfig(pre_nms_top_n=60, post_nms_top_n=8),
                                     keypoint=config.KeypointConfig(num_convs=2, conv_dim=32))
config.PRESETS[preset] = cfg
cfg32 = cfg.replace(compute_dtype="float32")
params = params_from_jax(init_params(cfg, seed=0))
tcfg = config.TestConfig(target_size=64, max_size=96, detections_per_img=4, score_thresh=0.0,
                         exact_blob_dims=True)
images = torch.from_numpy(np.random.RandomState(0).randn(1, 64, 96, 3).astype(np.float32))
meta = [torch.ones(1), torch.full((1,), 64.0), torch.full((1,), 96.0)]
out = make_inference_fn(cfg32, tcfg)(params, images, *meta)
assert out.keypoints.shape == (1, 12, 17, 4) and out.masks is None
kps = make_keypoint_fn(cfg32)(params, images, *meta, out.detections.boxes)
assert kps.shape == (1, 12, 17, 4)
bbox, segm, info = evaluate_dataset(cfg32, tcfg.replace(device_preprocess=True), params,
                                    CocoDataset(ann, imdir), verbose=False, batch_size=2,
                                    device="cpu")
assert segm is None and len(info["keypoints_stats"]) == 10 and info["keypoints"]
r = 8
batch = {"image": images, "rois": torch.tensor([[[4.0, 4.0, 40.0, 30.0]] * r]),
         "labels": torch.tensor([[1] + [0] * (r - 1)]), "valid": torch.ones(1, r, dtype=bool),
         "bbox_targets": torch.zeros(1, r, 8), "bbox_inside_weights": torch.zeros(1, r, 8),
         "bbox_outside_weights": torch.zeros(1, r, 8),
         "kp_labels": torch.randint(0, 3136, (1, 2, 17)), "kp_valid": torch.ones(1, 2, 17, dtype=bool)}
init_state, make_step = make_train_step(cfg32)
state, opt = init_state(params)
state, metrics = make_step(opt)(state, batch)
assert torch.isfinite(metrics["loss_kps"])
train_fast.main(["--keypoints", "--e2e", "--ann", ann, "--imdir", imdir,
                 "--out", os.path.join(tmp, "run"), "--max-iter", "1", "--target-size", "64",
                 "--max-size", "96", "--blob", "64", "96", "--rois-per-image", "16",
                 "--device", "cpu"])
assert os.path.exists(os.path.join(tmp, "run", "ckpt-1"))
""" + LEAK_CHECK
    # the Tier-1 command's six workers share the cores: one torch thread
    proc = _python(["-c", code, str(tmp_path)], cwd=REPO,
                   env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_parallel_paths_run_without_jax():
    # two ranks on gloo: the mesh, its collectives, the column-parallel
    # product and the eval results' gather in each rank's own interpreter
    # (``torch_dist_case.leak_check_rank`` lists what leaked there), the
    # multi-rank trainer, eval and dry run imported here
    code = """
import sys
import detectorch_tpu_torch.eval.engine, detectorch_tpu_torch.tools.train_fast
import detectorch_tpu_torch.tools.dryrun_multichip
from detectorch_tpu_torch.parallel.launch import run_ranks
from tests.torch_dist_case import leak_check_rank
ranks = run_ranks(leak_check_rank, 2)
assert ranks == [[], []], ranks
""" + LEAK_CHECK
    proc = _python(["-c", code], cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_demo_and_utilities_run_without_jax(tmp_path):
    # the demo CLI on the CPU (a small preset, random weights) through
    # run_demo and the native RLE, under debug's checked; then
    # assert_finite_tree, vis under profiling's trace, device_timer, io,
    # colormap and selective_search
    code = """
import os, sys
import cv2
import numpy as np
import torch
import detectorch_tpu_torch.config as config
from detectorch_tpu_torch.eval import rle, rle_native
from detectorch_tpu_torch.tools import demo
from detectorch_tpu_torch.utils import colormap, io, selective_search, vis
from detectorch_tpu_torch.utils.debug import assert_finite_tree, checked
from detectorch_tpu_torch.utils.profiling import device_timer, trace

tmp = sys.argv[1]
preset = "e2e_mask_rcnn_R-50-FPN_2x"
config.PRESETS[preset] = config.PRESETS[preset].replace(
    compute_dtype="float32", rpn=config.RPNConfig(pre_nms_top_n=60, post_nms_top_n=12))
small = config.TestConfig
config.TestConfig = lambda: small(target_size=48, max_size=64, detections_per_img=4,
                                  score_thresh=0.0, exact_blob_dims=True)
image = os.path.join(tmp, "in.png")
cv2.imwrite(image, np.random.RandomState(0).randint(0, 256, (40, 60, 3)).astype(np.uint8))
out = os.path.join(tmp, "out.png")
res = checked(demo.main)(["--image", image, "--out", out, "--thresh", "0.0",
                          "--device", "cpu"])
assert cv2.imread(out).shape == (40, 60, 3) and len(res["rles"]) == len(res["scores"]) > 0
assert rle_native.library.path.exists() and rle.decode(res["rles"][0]).shape == (40, 60)
assert_finite_tree(res)
with trace(os.path.join(tmp, "trace")):
    vis.vis_one_image_opencv(cv2.imread(image), res["boxes"], res["scores"], res["classes"],
                             res["rles"], thresh=0.0)
assert os.listdir(os.path.join(tmp, "trace"))
assert device_timer(lambda: torch.ones(8) * 2, iters=2) > 0
io.save_object(colormap.colormap(), os.path.join(tmp, "c.pkl"))
assert len(selective_search.selective_search(np.zeros((40, 60, 3), np.uint8))) > 0
""" + LEAK_CHECK
    # the Tier-1 command's six workers share the cores: one torch thread
    proc = _python(["-c", code, str(tmp_path)], cwd=REPO,
                   env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_production_ap_runs_without_jax(tmp_path):
    # the probe fit on a 2-image data/synth set and the ladder's row 1, on
    # the CPU, through the CLI's main
    code = """
import sys
from detectorch_tpu_torch.tools import production_ap
rows = production_ap.main(["--device", "cpu", "--images", "2", "--root", sys.argv[1],
                           "--presets", "e2e_faster_rcnn_R-50-FPN_2x"])
assert [r["variant"] for r in rows] == ["fp32/plain (baseline)"] and rows[0]["bbox_ap"] > 0
""" + LEAK_CHECK
    # the Tier-1 command's six workers share the cores: one torch thread
    proc = _python(["-c", code, str(tmp_path)], cwd=REPO,
                   env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_measurement_tools_run_without_jax():
    # bench's default mode, profile_stages' CLI and profile_mfu's count
    # against its closed form, on the CPU at a tiny size (small RPN counts,
    # 4 detection slots, bench's bucket set to 64x64)
    code = """
import json, sys
import detectorch_tpu_torch.config as config
from detectorch_tpu_torch.tools import bench, profile_mfu, profile_stages

preset = "e2e_mask_rcnn_R-50-FPN_2x"
config.PRESETS[preset] = config.PRESETS[preset].replace(
    compute_dtype="float32", rpn=config.RPNConfig(pre_nms_top_n=60, post_nms_top_n=8))
small = config.TestConfig
bench.TestConfig = profile_stages.TestConfig = profile_mfu.TestConfig = \
    lambda **kw: small(detections_per_img=4, **kw)
bench.HEIGHT = bench.WIDTH = 64
line = bench.main({"BENCH_DEVICE": "cpu", "BENCH_PER_DEV_BATCH": "1", "BENCH_ITERS": "1"})
assert line["vs_baseline"] is None and line["device"] == "cpu", line
res = profile_stages.main(["--device", "cpu", "--batch", "1", "--iters", "1"])
assert [s[0] for s in res["stages"]][-2:] == ["mask roialign", "mask head"]
rows = profile_mfu.main(["--device", "cpu", "--batch", "1"])
assert rows["matmul"] == [] and rows["flops"][0]["closed_form_equal"]
""" + LEAK_CHECK
    # the Tier-1 command's six workers share the cores: one torch thread
    proc = _python(["-c", code], cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_data_ships_every_port_source():
    # an installed copy builds the kernels and the native RLE from these
    import fnmatch

    setup = open(os.path.join(REPO, "setup.py")).read()
    globs = re.findall(r'"(csrc/[^"]+)"', re.search(
        r'package_data=\{"detectorch_tpu_torch": \[([^\]]*)\]\}', setup).group(1))
    csrc = os.path.join(REPO, "detectorch_tpu_torch", "csrc")
    sources = sorted(os.listdir(csrc))
    assert {"rle_native.cpp", "roi_align_fwd.cu", "roi_align_bwd.cu"} <= set(sources)
    assert [f for f in sources if not any(fnmatch.fnmatch(f"csrc/{f}", g) for g in globs)] == []


def test_no_jax_import_in_port_sources():
    # neither jax nor any module of the JAX package, at any indentation
    pattern = re.compile(r"^\s*(import|from) (jax|detectorch_tpu)(\.|\s|$)", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tests",
                                                               "torch_dist_case.py")]
    for root, _, files in os.walk(os.path.join(REPO, "detectorch_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for rel in ("train/e2e.py", "tools/make_proposals.py", "tools/train_fast.py",
                "parallel/mesh.py", "parallel/launch.py", "parallel/dryrun.py",
                "tools/dryrun_multichip.py", "tools/multicard_check.py", "tools/demo.py",
                "eval/rle_native.py", "utils/vis.py", "utils/colormap.py", "utils/io.py",
                "utils/selective_search.py", "utils/debug.py", "utils/profiling.py",
                "tools/probe_weights.py", "tools/production_ap.py", "tools/measure.py",
                "tools/bench.py", "tools/bench_e2e.py", "tools/profile_e2e_train.py",
                "tools/profile_stages.py", "tools/profile_mfu.py"):
        assert os.path.join(REPO, "detectorch_tpu_torch", rel) in paths, rel
    # nor the repository's tests (the AP harness, the mirror) from the package
    tests_import = re.compile(r"^\s*(import|from) tests(\.|\s|$)", re.M)
    package = [p for p in paths if os.sep + "detectorch_tpu_torch" + os.sep in p]
    assert not [p for p in package if tests_import.search(open(p).read())]
    assert tests_import.search("from tests import ap_harness\n")
    # the native RLE's loader reads its own source, which needs neither
    # Python's headers nor numpy's, nor the JAX package's extension
    loader = open(os.path.join(REPO, "detectorch_tpu_torch", "eval", "rle_native.py")).read()
    assert '"csrc" / "rle_native.cpp"' in loader and "detectorch_tpu_rle_native" not in loader
    cpp = open(os.path.join(REPO, "detectorch_tpu_torch", "csrc", "rle_native.cpp")).read()
    includes = re.findall(r"^#include [<\"](.+)[>\"]", cpp, re.M)
    assert includes and not [h for h in includes if "Python" in h or "numpy" in h], includes
    offenders = [p for p in paths if pattern.search(open(p).read())]
    assert not offenders
    assert pattern.search("    from detectorch_tpu.config import PRESETS\n")
    assert pattern.search("import detectorch_tpu\n")
    assert not pattern.search("from detectorch_tpu_torch.config import PRESETS\n")


def test_chip_smoke_fails_without_a_card(tmp_path):
    # in the checkout, on a machine without CUDA
    proc = _python(["chip_smoke.py"], cwd=REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    # alone in a directory, without the rest of the repository
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _python(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

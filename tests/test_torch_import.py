"""The port stands without JAX, and chip_smoke.py refuses to run without a card.

The machine with the card has no JAX, so importing the port must not pull
it in. conftest.py has already imported JAX into this process, so the
check runs in a fresh interpreter.
"""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import detectorch_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(args, cwd, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def _port_modules():
    return ["detectorch_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(detectorch_tpu_torch.__path__,
                                              "detectorch_tpu_torch.")]


def test_port_imports_without_jax():
    mods = _port_modules()
    assert "detectorch_tpu_torch.ops.cuda.roi_align_kernel" in mods
    assert "detectorch_tpu_torch.train.train_step" in mods
    assert "detectorch_tpu_torch.tools.train_fast" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "leaked = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            "print('LEAKED', leaked)\n"
            "sys.exit(1 if leaked else 0)\n")
    proc = _python(["-c", code], cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_training_data_path_runs_without_jax():
    # roidb entries built in memory, the port's bbox targets, then the JAX
    # package's sampler: with bbox_targets set, sample_rois never reaches
    # its own JAX-importing branch
    code = """
import sys
import numpy as np
from detectorch_tpu.config import SamplerConfig
from detectorch_tpu.data.coco import RoidbEntry
from detectorch_tpu.train.sampler import sample_rois
from detectorch_tpu_torch.data.roidb import add_bbox_regression_targets

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
add_bbox_regression_targets([entry])
assert entry.bbox_targets.shape == (len(boxes), 5) and entry.bbox_targets[2:10, 0].all()
blobs = sample_rois(entry, 1.5, rng, SamplerConfig(rois_per_image=16))
assert blobs["valid"].sum() > 0 and blobs["bbox_inside_weights"].sum() > 0
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print("LEAKED", leaked)
sys.exit(1 if leaked else 0)
"""
    proc = _python(["-c", code], cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "detectorch_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = [p for p in paths if pattern.search(open(p).read())]
    assert not offenders


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

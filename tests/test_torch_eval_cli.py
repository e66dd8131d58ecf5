"""``python -m detectorch_tpu_torch.tools.eval_coco`` on a tiny synthetic
COCO set, on the CPU: once from a Detectron pkl written by the JAX
package's ``save_caffe2_pkl`` (--weights), once from a checkpoint of the
port's trainer holding the same parameters (--ckpt). Both load the same
tensors (tests/test_torch_caffe2_import.py), so both must write the same
results.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from detectorch_tpu.checkpoint import caffe2_import as jc2
from detectorch_tpu.models.detector import init_params
from detectorch_tpu_torch.checkpoint import store
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.tools import eval_coco
from detectorch_tpu_torch.train.train_step import make_train_step, state_dict
from tests.torch_configs import both_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "e2e_mask_rcnn_R-50-FPN_2x"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from detectorch_tpu.data.synth import build_synth_coco

    root = tmp_path_factory.mktemp("evalcli")
    ann, imdir = build_synth_coco(str(root / "ds"), n_images=2, height=96, width=128, seed=3)
    cfg, pcfg = both_configs(lambda c: c.PRESETS[PRESET])
    params = {k: np.asarray(v) for k, v in init_params(cfg, seed=0).items()}
    # random weights score every class near 1/81, under the 0.05 threshold:
    # make two classes confident so that detections (and masks) come out
    b = params["cls_score_b"].copy()
    b[[1, 2]] = 6.0
    params["cls_score_b"] = b
    pkl = str(root / "model.pkl")
    jc2.save_caffe2_pkl(params, cfg, pkl)
    init_state, _ = make_train_step(pcfg)
    state, _ = init_state(params_from_jax(params))
    run = str(root / "run")
    store.save_checkpoint(run, 5, state_dict(state))
    return ann, imdir, pkl, run, root


def _eval(setup, source, name):
    ann, imdir, _, _, root = setup
    out = str(root / f"{name}.json")
    proc = subprocess.run(
        [sys.executable, "-m", "detectorch_tpu_torch.tools.eval_coco", "--preset", PRESET,
         *source, "--ann", ann, "--imdir", imdir, "--out", out, "--fp32", "--exact-blob",
         "--target-sizes", "96", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        # the Tier-1 command's six workers share the cores: one torch thread
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return proc.stdout, json.load(f)


def test_eval_cli_weights_and_ckpt(setup):
    _, _, pkl, run, _ = setup
    out_w, res_w = _eval(setup, ["--weights", pkl], "weights")
    out_c, res_c = _eval(setup, ["--ckpt", run], "ckpt")
    assert f"loading weights {pkl}" in out_w
    assert f"loading checkpoint {os.path.join(run, 'ckpt-5')}" in out_c
    for out in (out_w, out_c):
        lines = out.splitlines()
        assert any(line.startswith("throughput: ") and line.endswith("images/sec on cpu")
                   for line in lines)
        ap = [line for line in lines if line.startswith(("box AP: ", "mask AP: "))]
        assert len(ap) == 2 and all(0.0 <= float(line.split()[-1]) <= 100.0 for line in ap)
    assert len(res_w["bbox"]) == len(res_w["segm"]) > 0
    assert {r["category_id"] for r in res_w["bbox"]} <= {1, 2}
    assert res_w == res_c


@pytest.mark.parametrize("argv", [
    ["--weights", "w.pkl", "--roi-align-fwd", "bf16"],  # only the exact RoIAlign
    ["--weights", "w.pkl", "--ckpt", "run"],            # one source of weights
    [],                                                 # and not none
])
def test_eval_cli_refuses(argv):
    with pytest.raises(SystemExit):
        eval_coco.parse_args(["--preset", PRESET, "--ann", "a.json", "--imdir", "im", *argv])

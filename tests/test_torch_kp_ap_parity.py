"""Full-pipeline AP parity of the port on Keypoint R-CNN: its
``evaluate_dataset`` on ``e2e_keypoint_rcnn_R-50-FPN_1x`` (full width:
8 convs of 512, 17 keypoints, 56x56 heatmaps) against the torch + numpy
mirror of the reference pipeline (tests/ap_harness.py, family
``r50_fpn_kp``: 2-class head probes and a trained kps_score_lowres probe),
on the harness's person-keypoints synthetic set, scored by the same
COCOeval. Every one of the 12 bbox stats and the 10 OKS stats must lie
within AP_TOL = 2e-4, as tests/test_ap_parity.py holds the JAX package.

The set and the probe weights are built once, in a directory of the test
session's own; this file stands alone so that the build lands on its own
worker. It is marked slow: alone, on one thread, it takes ~270 s (the
probe-weight build and both pipelines run the full-width keypoint trunk on
every detection), more than the Tier-1 run can give one file.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from detectorch_tpu_torch import config as torch_config
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.data.coco import CocoDataset
from detectorch_tpu_torch.eval.engine import evaluate_dataset
from tests.ap_harness import (
    FPN_RPN,
    family_of,
    harness_cfg,
    make_probe_weights,
    mirror_evaluate,
    prepare_keypoint_dataset,
)

pytestmark = pytest.mark.slow

AP_TOL = 2e-4
PRESET = "e2e_keypoint_rcnn_R-50-FPN_1x"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ap_parity_keypoints(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ap_synth_kp"))
    dataset = prepare_keypoint_dataset(root=root)
    cfg, tcfg = harness_cfg(PRESET)
    assert family_of(PRESET) == "r50_fpn_kp" and cfg.rpn == FPN_RPN
    # the harness's configuration, built from the port's own PRESETS
    c = torch_config
    pcfg = c.PRESETS[PRESET].replace(
        compute_dtype="float32", roi_align_precision="highest",
        rpn=c.RPNConfig(pre_nms_top_n=FPN_RPN.pre_nms_top_n,
                        post_nms_top_n=FPN_RPN.post_nms_top_n))
    ptcfg = c.TestConfig(target_size=256, max_size=320, exact_blob_dims=True, max_proposals=256)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(ptcfg) == dataclasses.asdict(tcfg)
    params = make_probe_weights("r50_fpn_kp", dataset, cache_root=root)
    pdataset = CocoDataset(os.path.join(root, "instances_synth.json"), dataset.image_directory)
    ours_bbox, ours_segm, info = evaluate_dataset(pcfg, ptcfg, params_from_jax(params),
                                                  pdataset, roidb=pdataset.get_roidb(gt=False),
                                                  verbose=False, device="cpu")
    mir_bbox, _, mir_kps = mirror_evaluate(cfg, tcfg, params, dataset,
                                           dataset.get_roidb(gt=False))
    ours_kps = info["keypoints_stats"]
    assert ours_segm is None and ours_kps is not None and len(ours_kps) == 10
    print("bbox max|diff|", np.max(np.abs(np.subtract(ours_bbox, mir_bbox))),
          "kps max|diff|", np.max(np.abs(np.subtract(ours_kps, mir_kps))),
          "bbox AP", ours_bbox[0], "kps AP", ours_kps[0])
    assert ours_bbox[0] > 0.05 and ours_kps[0] > 0.05, (ours_bbox[0], ours_kps[0])
    np.testing.assert_allclose(ours_bbox, mir_bbox, rtol=0, atol=AP_TOL)
    np.testing.assert_allclose(ours_kps, mir_kps, rtol=0, atol=AP_TOL)

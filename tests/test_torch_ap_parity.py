"""Full-pipeline AP parity of the port: its ``evaluate_dataset`` against the
torch + numpy mirror of the reference pipeline (tests/ap_harness.py), on the
harness's synthetic COCO set with its probe weights, scored by the same
COCOeval. Every one of the 12 bbox stats (and the 12 segm stats of a mask
preset) must lie within AP_TOL = 2e-4, as tests/test_ap_parity.py holds the
JAX package.

The synthetic set and the r50_fpn probe weights, which every test here
shares, are built once per run in a directory of the test session's own;
keeping the tests in one file keeps that build to one worker.
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
    family_of,
    harness_cfg,
    make_probe_weights,
    mirror_evaluate,
    prepare_dataset,
)

AP_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The Tier-1 command runs six pytest workers on the CPU; torch's
    per-op thread pool in each of them oversubscribes the cores and slows
    these runs several-fold. One intra-op thread per worker in this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """(dataset, proposals file, harness root) in a directory of this run."""
    root = str(tmp_path_factory.mktemp("ap_synth"))
    return (*prepare_dataset(root=root), root)


def _port_configs(preset, **tcfg_overrides):
    """The harness's configuration (tests/ap_harness.harness_cfg, FPN presets)
    built from the port's own PRESETS and dataclasses."""
    c = torch_config
    cfg = c.PRESETS[preset].replace(compute_dtype="float32", roi_align_precision="highest",
                                    rpn=c.RPNConfig(pre_nms_top_n=300, post_nms_top_n=100))
    tcfg = c.TestConfig(target_size=256, max_size=320, exact_blob_dims=True, max_proposals=256,
                        **tcfg_overrides)
    return cfg, tcfg


def _parity(preset, synth, **tcfg_overrides):
    dataset, proposals_file, root = synth
    cfg, tcfg = harness_cfg(preset)
    tcfg = tcfg.replace(**tcfg_overrides)
    pcfg, ptcfg = _port_configs(preset, **tcfg_overrides)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(ptcfg) == dataclasses.asdict(tcfg)
    params = make_probe_weights(family_of(preset), dataset, cache_root=root)
    # the port reads the set through its own CocoDataset
    pdataset = CocoDataset(os.path.join(root, "instances_synth.json"), dataset.image_directory)
    roidb = (pdataset.get_roidb(gt=False) if cfg.use_rpn
             else pdataset.get_roidb(gt=False, proposal_file=proposals_file))
    ours_bbox, ours_segm, info = evaluate_dataset(
        pcfg, ptcfg, params_from_jax(params), pdataset, roidb=roidb, verbose=False,
        device="cpu")
    roidb = (dataset.get_roidb(gt=False) if cfg.use_rpn
             else dataset.get_roidb(gt=False, proposal_file=proposals_file))
    mir_bbox, mir_segm, _ = mirror_evaluate(cfg, tcfg, params, dataset, roidb)
    assert ours_bbox is not None and mir_bbox is not None
    assert ours_bbox[0] > 0.05, f"degenerate box AP {ours_bbox[0]}"
    np.testing.assert_allclose(ours_bbox, mir_bbox, rtol=0, atol=AP_TOL)
    if cfg.use_mask:
        assert ours_segm is not None and mir_segm is not None and ours_segm[0] > 0.05
        np.testing.assert_allclose(ours_segm, mir_segm, rtol=0, atol=AP_TOL)
    else:
        assert ours_segm is None
    return info


@pytest.mark.parametrize("preset", ["e2e_mask_rcnn_R-50-FPN_2x", "fast_rcnn_R-50-FPN_2x"])
def test_ap_parity(preset, synth):
    _parity(preset, synth)


@pytest.mark.parametrize("overrides", [
    # the on-device resize differs from the mirror's cv2 resize by float32
    # blend order (~1e-4 per pixel), which must not move a stat
    {"device_preprocess": True},
    {"soft_nms": True},
    {"do_bbox_vote": True},
], ids=["device_preprocess", "soft_nms", "bbox_vote"])
def test_ap_parity_test_options(overrides, synth):
    """The postprocess and input options, on e2e_faster_rcnn_R-50-FPN_2x,
    against the mirror driving the reference's branches."""
    _parity("e2e_faster_rcnn_R-50-FPN_2x", synth, **overrides)

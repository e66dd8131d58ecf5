"""Full-pipeline AP parity of the port on the C4 family: its
``evaluate_dataset`` on ``e2e_mask_rcnn_R-50-C4_2x``,
``fast_rcnn_R-50-C4_2x`` (the set's precomputed proposals) and
``e2e_faster_rcnn_R-50-C4_2x`` against the torch + numpy mirror of the
reference pipeline (tests/ap_harness.py, family ``r50_c4``), on the
harness's synthetic COCO set with its probe weights, scored by the same
COCOeval. Every one of the 12 bbox stats (and the 12 segm stats of the mask
preset) must lie within AP_TOL = 2e-4, as tests/test_torch_ap_parity.py
holds the FPN presets.

The set and the r50_c4 probe weights are built once, in a directory of the
test session's own; this file stands alone so that the build lands on its
own worker. It is marked slow: alone, on one thread, the mask preset takes
~680 s (the probe-weight build and both pipelines run res5 on every roi),
more than the Tier-1 run can give one file.
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
    C4_RPN,
    family_of,
    harness_cfg,
    make_probe_weights,
    mirror_evaluate,
    prepare_dataset,
)

pytestmark = pytest.mark.slow

AP_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth_c4(tmp_path_factory):
    """(dataset, proposals file, root) with the r50_c4 probe weights built."""
    root = str(tmp_path_factory.mktemp("ap_synth_c4"))
    dataset, proposals_file = prepare_dataset(root=root)
    make_probe_weights("r50_c4", dataset, cache_root=root)
    return dataset, proposals_file, root


@pytest.mark.parametrize("preset", [
    "e2e_mask_rcnn_R-50-C4_2x", "fast_rcnn_R-50-C4_2x", "e2e_faster_rcnn_R-50-C4_2x"])
def test_ap_parity_c4(preset, synth_c4):
    dataset, proposals_file, root = synth_c4
    cfg, tcfg = harness_cfg(preset)
    assert family_of(preset) == "r50_c4" and cfg.rpn == C4_RPN
    # the harness's configuration, built from the port's own PRESETS
    c = torch_config
    pcfg = c.PRESETS[preset].replace(
        compute_dtype="float32", roi_align_precision="highest",
        rpn=c.RPNConfig(pre_nms_top_n=C4_RPN.pre_nms_top_n,
                        post_nms_top_n=C4_RPN.post_nms_top_n))
    ptcfg = c.TestConfig(target_size=256, max_size=320, exact_blob_dims=True, max_proposals=256)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(ptcfg) == dataclasses.asdict(tcfg)
    params = make_probe_weights("r50_c4", dataset, cache_root=root)
    pdataset = CocoDataset(os.path.join(root, "instances_synth.json"), dataset.image_directory)
    proposals = {} if cfg.use_rpn else {"proposal_file": proposals_file}
    ours_bbox, ours_segm, _ = evaluate_dataset(pcfg, ptcfg, params_from_jax(params), pdataset,
                                               roidb=pdataset.get_roidb(gt=False, **proposals),
                                               verbose=False, device="cpu")
    mir_bbox, mir_segm, _ = mirror_evaluate(cfg, tcfg, params, dataset,
                                            dataset.get_roidb(gt=False, **proposals))
    assert ours_bbox[0] > 0.05, ours_bbox[0]
    np.testing.assert_allclose(ours_bbox, mir_bbox, rtol=0, atol=AP_TOL)
    if cfg.use_mask:
        assert ours_segm[0] > 0.05, ours_segm[0]
        np.testing.assert_allclose(ours_segm, mir_segm, rtol=0, atol=AP_TOL)
    else:
        assert ours_segm is None and mir_segm is None

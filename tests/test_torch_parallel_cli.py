"""The port's multi-rank entry points on the CPU: the trainer's batch rows,
the multi-rank dry run and the multi-card check's arithmetic. The trainer
under two ranks runs in the shared rank job of tests/test_torch_parallel.py.

The dry run's ranks run on the gloo backend through
``parallel.launch.run_ranks`` (spawn processes, a ``file://`` rendezvous in
a temporary directory, one torch thread each). Batch rows are held
bitwise.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from detectorch_tpu_torch.config import PRESETS, SamplerConfig, TestConfig
from detectorch_tpu_torch.data.coco import roidb_for_training
from detectorch_tpu_torch.data.synth import build_synth_coco, write_proposals_pkl
from detectorch_tpu_torch.parallel.dryrun import dryrun_multichip
from detectorch_tpu_torch.tools import train_fast


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("e2e", [False, True], ids=["host-sampled", "e2e"])
def test_batch_maker_rank_rows_are_world1_rows(tmp_path, e2e):
    """Each rank's ``BatchMaker`` gives, batch after batch, its rows of the
    batch one process draws (the one RandomState picks the images and the
    roi sampler's draws), without reading the other ranks' images."""
    ann, imdir = build_synth_coco(str(tmp_path / "ds"), n_images=5, height=60, width=90,
                                  seed=4)
    props = None if e2e else write_proposals_pkl(ann, str(tmp_path / "props.pkl"))
    args = SimpleNamespace(seed=3, blob=(64, 96), batch_size=None, device_preprocess=False,
                           e2e=e2e, masks=True, keypoints=False)
    cfg = PRESETS["e2e_mask_rcnn_R-50-FPN_2x"]
    sampler = SamplerConfig(rois_per_image=16)
    tcfg = TestConfig(target_size=64, max_size=96)
    _, roidb = roidb_for_training(ann, imdir, props)
    world1 = train_fast.BatchMaker(args, cfg, sampler, tcfg, roidb, 4)
    ranks = [train_fast.BatchMaker(args, cfg, sampler, tcfg, roidb, 4, range(2 * r, 2 * r + 2))
             for r in range(2)]
    for _ in range(3):
        whole = world1()
        parts = [make() for make in ranks]
        assert set(whole) == set(parts[0]) and len(whole["image"]) == 4
        for k, v in whole.items():
            np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), v, err_msg=k)


def test_dryrun_multichip_two_ranks_on_cpu():
    """``dryrun_multichip(2)`` on the CPU at small blobs: data 1 x model 2,
    the e2e Mask R-CNN step's losses finite and equal on both ranks, the
    sharded inference held to one process (``compare_outputs``)."""
    results = dryrun_multichip(2, "cpu", train_hw=(64, 96), infer_hw=(64, 96))
    assert [r["rank"] for r in results] == [0, 1]
    for r in results:
        assert r["mesh"] == {"data": 1, "model": 2}
        assert r["losses"] == results[0]["losses"]
        assert np.isfinite(r["losses"]["loss_mask"]) and r["compare"]["detections"] > 0


def test_multicard_check_times_and_refusal():
    """``tools/multicard_check``: each iteration's seconds from the
    trainer's running mean, and a refusal without two CUDA cards."""
    from detectorch_tpu_torch.tools.multicard_check import iteration_times, main

    stats = [{"time": 4.0}, {"time": 2.5}, {"time": 2.0}]
    np.testing.assert_allclose(iteration_times(stats), [4.0, 1.0, 1.0])
    with pytest.raises(SystemExit, match="at least two"):
        main()

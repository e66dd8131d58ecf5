"""The port's ResNeXt trunk (``models/resnet``, arch ``resnext101_64x4d``)
against the benchmark's plain reference (``benchmark/reference/resnext.py``)
on seeded random weights in fp32 on the CPU: one grouped bottleneck with
and without its stride, the trunk at one block a stage with its full group
widths, the whole request at the benchmark's small CPU size, and the caffe2
importer on grouped ``branch2b`` blobs. Nothing runs at full depth: each
test that builds a trunk cuts it to one block a stage, on both sides."""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import check, infer_resnext, program
from benchmark.harness.traffic import make_pool
from benchmark.harness.weights import make_blobs
from benchmark.reference import model as M
from benchmark.reference import resnext as R
from benchmark.tests.small import SEED, shrink
from detectorch_tpu_torch.checkpoint.caffe2_import import import_base_cnn, import_params
from detectorch_tpu_torch.models import resnet

ARCH = "resnext101_64x4d"
CELL = "x101_mask.infer_b8"
TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 sums in another order, through relu and bn


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_block(monkeypatch):
    """The cell's configuration with its trunk cut to one block a stage, in
    the configuration and in the port's architecture alike (widths and
    groups as published)."""
    _, _, settings, cfg, mix = run.load_cell(CELL)
    cfg["trunk"]["blocks"] = [1, 1, 1, 1]
    monkeypatch.setitem(resnet.STAGE_BLOCKS, ARCH, (1, 1, 1, 1))
    return settings, cfg, mix


def _trunk_blobs(cfg, seed):
    """Every trunk blob of `cfg`, He-scaled, with frozen BN away from 1 and 0."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in R._trunk_spec(cfg).items():
        if name.endswith("_w"):
            out[name] = torch.randn(shape, generator=g) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif name.endswith("_bn_s"):
            out[name] = 0.5 + torch.rand(shape, generator=g)
        else:
            out[name] = 0.1 * torch.randn(shape, generator=g)
    return out


@pytest.mark.parametrize("si,stride", [(0, 1), (1, 2)])
def test_grouped_bottleneck_matches_reference(one_block, si, stride):
    _, cfg, _ = one_block
    P = _trunk_blobs(cfg, 11 + si)
    cin = 64 if si == 0 else M.STAGES[si - 1][1]
    x = torch.relu(torch.randn(2, cin, 12, 16, generator=torch.Generator().manual_seed(3)))
    q = M.Precision()
    with check.fp32_only(), torch.no_grad():
        got = resnet.bottleneck(P, x.contiguous(memory_format=torch.channels_last),
                                f"{M.STAGES[si][0]}_0", stride, True, resnet.groups_of(ARCH))
        exp = R.stage(cfg, P, q, x, si, stride)
        cfg["trunk"]["stride_1x1"] = True  # the ResNet rule: the stride on branch2a
        wrong = R.stage(cfg, P, q, x, si, stride)
    assert got.shape == exp.shape == (2, M.STAGES[si][1], 12 // stride, 16 // stride)
    torch.testing.assert_close(got, exp, **TOL)
    if stride > 1:
        with pytest.raises(AssertionError):
            torch.testing.assert_close(got, wrong, **TOL)
    else:  # without a stride both rules are one block
        torch.testing.assert_close(got, wrong, **TOL)


def test_trunk_at_one_block_a_stage_matches_reference(one_block):
    _, cfg, _ = one_block
    blobs = _trunk_blobs(cfg, 5)
    params = import_base_cnn({k: v.numpy() for k, v in blobs.items()}, ARCH)
    assert params["res4_0_branch2b_w"].shape == (1024, 16, 3, 3)
    images = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(4)) * 40
    with check.fp32_only(), torch.no_grad():
        got = resnet.multilevel_body(params, images, ARCH)
        exp = R.body(cfg, blobs, M.Precision(), images)
    for k, e in zip(("c2", "c3", "c4", "c5"), exp):
        # the maps grow stage by stage: fp32 rounding relative to each map's scale
        torch.testing.assert_close(resnet.to_nchw(got[k]), e, rtol=0,
                                   atol=1e-5 * float(e.abs().max()))


def test_request_matches_reference(one_block):
    """The whole request at the benchmark's small CPU size (one image a
    batch): caffe2 blobs through ``import_params``, the timed entry, then
    the cell's check reads every gap at fp32 rounding. The importer
    refuses a dense ``branch2b`` where the trunk is grouped."""
    settings, cfg, mix = one_block
    shrink(settings, cfg, mix)
    mix["batch"] = 1
    cfg["model"]["compute_dtype"] = "float32"
    with infer_resnext.pointed_at_resnext(cfg):
        blobs = make_blobs(cfg, SEED, "cpu")
        model_cfg, test_cfg = program.port_configs(cfg)
        assert model_cfg.arch == ARCH
        params = program.load_params(blobs, model_cfg, "cpu")
        assert params["res3_0_branch2b_w"].shape == (512, 8, 3, 3)
        batch = make_pool(mix, SEED, "cpu")[0]
        out = program.inference_fn(model_cfg, test_cfg, "cpu")(params, *batch)
        d = out.detections
        answers = program.per_image(out, (d.boxes, d.scores, d.classes, d.valid, out.masks))
        assert int(answers[0]["roi_valid"].sum()) == 300
        assert int(answers[0]["det_valid"].sum()) == 100
        n = check.judge(cfg, settings["roi_pre_margin"], blobs, [(batch, answers)])
    assert n["roi_unmatched"] == 0
    assert all(n[k] < 1e-4 for k in ("cls_gap", "det_score_gap", "det_select_gap", "mask_gap"))
    host = {k: v.numpy() for k, v in blobs.items()}
    host["res3_0_branch2b_w"] = np.zeros((512, 512, 3, 3), np.float32)
    with pytest.raises(ValueError, match="res3_0_branch2b_w"):
        import_params(host, model_cfg)

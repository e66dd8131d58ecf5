"""The port's measurement tools (``detectorch_tpu_torch/tools/{bench,
bench_e2e,profile_e2e_train,profile_stages,profile_mfu}``) on the CPU.

Small configurations (RPN 300 -> 64, fp32 where JAX is compared, 64x96
images, one torch thread): bench's inference function against the port's
``make_inference_fn`` (bitwise) and JAX's ``make_batched_inference_fn``
(the tolerances of tests/test_torch_detector.py); bench's train mode
against a direct ``make_train_step`` (bitwise) on JAX's bench batch; the
lines' keys; ``profile_stages`` composed bitwise to ``make_inference_fn``
on FPN mask, C4 mask and keypoint presets; ``profile_mfu``'s count against
its closed form plus ``roi_align_work`` on the request's own rois, and
under XLA's cost analysis of JAX's program; ``profile_e2e_train``'s cost
line and ``bench_e2e`` on 4 images; every tool's refusal of the card
without one, and the mesh's. Times read here are CPU times and are not
checked.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.models import detector as jdet
from detectorch_tpu.parallel import mesh as JM
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch import config as pconfig
from detectorch_tpu_torch.config import PRESETS, KeypointConfig, RPNConfig, SolverConfig
from detectorch_tpu_torch.models import detector as tdet
from detectorch_tpu_torch.parallel import mesh as M
from detectorch_tpu_torch.tools import (
    bench,
    bench_e2e,
    measure,
    profile_e2e_train,
    profile_mfu,
    profile_stages,
)
from detectorch_tpu_torch.train.train_step import make_train_step
from tests.torch_configs import both_configs

CPU = torch.device("cpu")
B, H, W = 2, 64, 96
# test_torch_detector.py's setting and tolerances
CFG, PCFG = both_configs(lambda c: c.PRESETS["e2e_mask_rcnn_R-50-FPN_2x"].replace(
    compute_dtype="float32",
    rpn=c.RPNConfig(pre_nms_top_n=300, post_nms_top_n=64),
    use_pallas_roi_align=False,
))
TCFG, PTCFG = both_configs(lambda c: c.TestConfig(detections_per_img=16, score_thresh=0.0))
ROI_ATOL, ATOL = 2e-3, 1e-5
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "tier"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Six pytest workers share the cores: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def flagship():
    """bench's inference setup on the CPU, its outputs, make_inference_fn's
    on the same params and rows, and JAX's batched program (its outputs and
    XLA's FLOP count) on the same numpy batch."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    fn, params, rows, mesh, b = bench.inference_setup(PCFG, PTCFG, CPU, B, H, W)
    torch.set_num_threads(n)
    inputs = bench.inference_inputs(B, H, W)
    jfn = JM.make_batched_inference_fn(CFG, TCFG, JM.make_mesh(jax.devices()[:1]))
    jp = jdet.init_params(CFG, seed=0)
    compiled = jfn.lower(jp, *map(jnp.asarray, inputs)).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    jout = jax.tree.map(np.asarray, compiled(jp, *map(jnp.asarray, inputs)))
    return {"fn": fn, "params": params, "rows": rows, "mesh": mesh, "batch": b,
            "inputs": inputs, "jout": jout, "xla_flops": float(cost["flops"])}


def test_bench_inputs_are_jax_benchs():
    images, scales, oh, ow = bench.inference_inputs(3, 16, 32)
    rng = np.random.RandomState(0)  # bench.py:78-82
    np.testing.assert_array_equal(images, (rng.randn(3, 16, 32, 3) * 50).astype(np.float32))
    assert scales.tolist() == [np.float32(1.66)] * 3 and oh.tolist() == [500.0] * 3
    assert ow.tolist() == [800.0] * 3 and images.dtype == scales.dtype == np.float32


def test_bench_inference_equals_make_inference_fn_and_jax(flagship):
    f = flagship
    assert f["mesh"].shape == {"data": 1, "model": 1} and f["batch"] == B
    for got, want in zip(f["rows"], f["inputs"]):
        np.testing.assert_array_equal(got.numpy(), want)
    out = f["fn"](f["params"], *f["rows"])
    ref = tdet.make_inference_fn(PCFG, PTCFG)(f["params"], *f["rows"])
    assert profile_stages.output_differences(out, ref) == []
    jo = f["jout"]
    d, jd = out.detections, jo.detections
    np.testing.assert_array_equal(out.roi_valid.numpy(), jo.roi_valid)
    for b in range(B):
        v = jo.roi_valid[b]
        assert v.sum() > 16
        np.testing.assert_allclose(out.rois[b].numpy(), jo.rois[b], rtol=0, atol=ROI_ATOL)
        np.testing.assert_allclose(out.cls_scores[b].numpy(), jo.cls_scores[b], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(out.bbox_deltas[b].numpy(), jo.bbox_deltas[b], rtol=0,
                                   atol=ATOL)
        assert int(d.valid[b].sum()) == int(jd.valid[b].sum()) >= 16
        np.testing.assert_allclose(np.sort(d.scores[b][d.valid[b]].numpy()),
                                   np.sort(jd.scores[b][jd.valid[b]]), rtol=0, atol=ATOL)
        matched = 0
        for i in np.flatnonzero(d.valid[b].numpy()):
            same = (jd.classes[b] == int(d.classes[b, i])) & jd.valid[b] & (
                np.abs(jd.boxes[b] - d.boxes[b, i].numpy()).max(axis=1) < ROI_ATOL)
            if same.any():
                j = int(np.flatnonzero(same)[0])
                np.testing.assert_allclose(out.masks[b, i].numpy(), jo.masks[b, j], rtol=0,
                                           atol=ATOL)
                matched += 1
        assert matched >= int(d.valid[b].sum()) // 2


def test_profile_mfu_count_is_closed_form_and_under_xla(flagship):
    f = flagship
    params = {k: v for k, v in f["params"].items()}
    row = profile_mfu.inference_flops(PCFG, PTCFG, CPU, B, H, W, params)
    count = row["count"]
    assert row["closed_form_equal"]
    assert count["layers"] == profile_mfu.inference_closed_form(PCFG, PTCFG, B, H, W)
    assert set(count["layers_by_op"]) == {"aten.convolution", "aten.addmm"}
    # the RoIAlign term from the request's own rois: the box call on the
    # proposals, each on its level, and the mask call on the detections
    out = tdet.make_inference_fn(PCFG, PTCFG)(f["params"], *f["rows"])
    shapes = [(B, H // s, W // s, 256) for s in (4, 8, 16, 32)]
    scales = PCFG.fpn_spatial_scales
    bidx = torch.arange(B, dtype=torch.int32)
    roi_ops = 0
    for rois, pooled in ((out.rois, 7), (out.detections.boxes * f["rows"][1][:, None, None], 14)):
        n = rois.shape[1]
        flat = rois.reshape(-1, 4).float()
        levels = tdet._roi_levels(PCFG, rois).reshape(-1).to(torch.int32)
        roi_ops += measure.roi_align_work(shapes, flat, bidx.repeat_interleave(n), levels,
                                          scales, pooled, 256)[1]
    assert count["roi_align"] == {"fwd": roi_ops, "bwd": 0}
    assert count["roi_align_calls"] == {"fwd": 2, "bwd": 0}
    assert row["flops"] == count["layers"] + roi_ops
    # XLA's cost analysis counts a conv's taps inside its input only (the
    # 3x3 convs of the small pyramid levels lose most to padding) and adds
    # the elementwise work and the gather RoIAlign's: under that
    # convention the port's count is no larger than XLA's
    inside = profile_mfu.inference_closed_form(PCFG, PTCFG, B, H, W, padding_taps=False)
    assert inside < count["layers"]
    assert 0.5 * f["xla_flops"] < inside + roi_ops <= f["xla_flops"]


def test_closed_form_counts_every_preset():
    for preset in ("e2e_faster_rcnn_R-50-FPN_2x", "e2e_mask_rcnn_R-50-C4_2x",
                   "e2e_keypoint_rcnn_R-50-FPN_1x"):
        cfg = PRESETS[preset].replace(rpn=RPNConfig(60, 8))
        if cfg.keypoint is not None:
            cfg = cfg.replace(keypoint=KeypointConfig(num_convs=2, conv_dim=32))
        tcfg = pconfig.TestConfig(detections_per_img=4, score_thresh=0.0)
        row = profile_mfu.inference_flops(cfg, tcfg, CPU, 1, 64, 64)
        assert row["closed_form_equal"], (preset, row["closed_form_layers"], row["count"])
        assert row["count"]["roi_align_calls"] == {
            "fwd": 1 if preset.startswith("e2e_faster") else 2, "bwd": 0}


def test_bench_lines_have_jax_keys(monkeypatch):
    small = PRESETS["e2e_mask_rcnn_R-50-FPN_2x"].replace(rpn=RPNConfig(60, 16))
    monkeypatch.setitem(PRESETS, "e2e_mask_rcnn_R-50-FPN_2x", small)
    monkeypatch.setattr(bench, "HEIGHT", 64)
    monkeypatch.setattr(bench, "WIDTH", 64)
    # 4 detection slots (+ 8 tie slots) for the mask head on the CPU
    monkeypatch.setattr(bench, "TestConfig",
                        lambda **kw: pconfig.TestConfig(detections_per_img=4, **kw))
    env = {"BENCH_DEVICE": "cpu", "BENCH_PER_DEV_BATCH": "1", "BENCH_ITERS": "2",
           "BENCH_COMPUTE_DTYPE": "float32"}
    line = bench.main(env)
    assert JAX_KEYS <= set(line) and line["vs_baseline"] is None
    assert line["metric"] == "mask_rcnn_r50_fpn_inference_throughput"
    assert line["device"] == "cpu" and line["peak_memory_gib"] is None
    assert len(line["ms"]) == 2 and line["requests"] == 2 and line["batch"] == 1
    assert line["launches"] == {"roi_align_fwd": 0, "roi_align_bwd": 0}  # plain versions
    assert line["tier"] == {"compute_dtype": "float32", "roi_align_precision": "high",
                            "roi_align_fwd_precision": "exact"}
    json.dumps(line)
    with pytest.raises(ValueError, match="bf16x3"):
        bench.main({**env, "BENCH_ROI_ALIGN_FWD": "bf16x3"})
    with pytest.raises(NotImplementedError):
        bench.main({**env, "BENCH_S2D_STEM": "1"})


def test_bench_train_step_equals_make_train_step():
    cfg = PRESETS[bench.TRAIN_PRESET].replace(compute_dtype="float32")
    k, r = cfg.num_classes, 16
    blobs = bench.train_inputs(k, B, r, H, W)
    # JAX's bench_train batch (bench.py:167-181)
    rng = np.random.RandomState(0)
    rois = np.stack([np.stack([
        rng.uniform(0, W / 2, r), rng.uniform(0, H / 2, r),
        rng.uniform(W / 2, W - 1, r), rng.uniform(H / 2, H - 1, r)], 1)
        for _ in range(B)]).astype(np.float32)
    np.testing.assert_array_equal(blobs["rois"], rois)
    np.testing.assert_array_equal(blobs["image"],
                                  (rng.randn(B, H, W, 3) * 40).astype(np.float32))
    np.testing.assert_array_equal(blobs["labels"], rng.randint(0, k, (B, r)).astype(np.int32))
    assert blobs["valid"].all() and not blobs["bbox_targets"].any()
    params = params_from_jax(tdet.init_params(cfg, seed=0))
    state, step, batch = bench.train_setup(cfg, CPU, B, H, W, r, params=params)
    init_state, make_step = make_train_step(cfg, SolverConfig(), roi_align_impl="gather")
    ref_state, opt = init_state({k_: v.clone() for k_, v in state.params.items()})
    ref_step = make_step(opt)
    for _ in range(2):
        state, metrics = step(state, batch)
        ref_state, ref_metrics = ref_step(ref_state, {k_: _t(v) for k_, v in blobs.items()})
        assert {k_: float(v) for k_, v in metrics.items()} == \
            {k_: float(v) for k_, v in ref_metrics.items()}
    for name, v in state.params.items():
        assert torch.equal(v, ref_state.params[name]), name


def test_bench_train_line(monkeypatch):
    monkeypatch.setattr(bench, "TRAIN_ROIS", 16)
    monkeypatch.setattr(bench, "HEIGHT", 64)
    monkeypatch.setattr(bench, "WIDTH", 64)
    line = bench.main({"BENCH_DEVICE": "cpu", "BENCH_MODE": "train", "BENCH_PER_DEV_BATCH": "1",
                       "BENCH_ITERS": "1"})
    assert JAX_KEYS <= set(line) and line["vs_baseline"] is None
    assert line["metric"] == "fast_rcnn_r50_fpn_train_step_throughput"
    assert line["device"] == "cpu" and np.isfinite(line["loss"]) and line["steps"] == 1


@pytest.mark.parametrize("preset", ["e2e_mask_rcnn_R-50-FPN_2x", "e2e_mask_rcnn_R-50-C4_2x",
                                    "e2e_keypoint_rcnn_R-50-FPN_1x"])
def test_profile_stages_composes_to_make_inference_fn(preset, capsys, monkeypatch):
    # C4 runs res5 on every roi slot: fewer slots
    cfg = PRESETS[preset].replace(compute_dtype="float32",
                                  rpn=RPNConfig(60, 16 if "FPN" in preset else 8))
    if cfg.keypoint is not None:
        cfg = cfg.replace(keypoint=KeypointConfig(num_convs=2, conv_dim=32))
    tcfg = pconfig.TestConfig(detections_per_img=4, score_thresh=0.0)
    params = params_from_jax(tdet.init_params(cfg, seed=0))
    inputs = tuple(_t(a) for a in bench.inference_inputs(B, H, W))
    res = profile_stages.profile(params, cfg, tcfg, inputs, CPU, iters=1)
    ref = tdet.make_inference_fn(cfg, tcfg)(params, *inputs)
    assert profile_stages.output_differences(res["outputs"], ref) == []
    names = [s[0] for s in res["stages"]]
    tail = (["keypoint roialign", "keypoint trunk + deconv + upsample", "decode"]
            if cfg.keypoint is not None else ["mask roialign", "mask head"])
    assert names == ["backbone + neck" if cfg.use_fpn else "backbone", "rpn + proposals",
                     "box roialign", "box head", "postprocess"] + tail
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["stage"] for x in lines[:-1]] == names
    assert lines[-1]["outputs_equal_fused"] and lines[-1]["device"] == "cpu"
    # a stage split that computes something else is refused
    make = tdet.make_inference_fn
    monkeypatch.setattr(profile_stages.det, "make_inference_fn",
                        lambda c, t: make(c, t.replace(detections_per_img=3)))
    with pytest.raises(RuntimeError, match="differs"):
        profile_stages.profile(params, cfg, tcfg, inputs, CPU, iters=0, echo=False)


def test_profile_e2e_train_cost_line():
    cfg = PRESETS["e2e_mask_rcnn_R-50-FPN_2x"]
    line = profile_e2e_train.profile(
        cfg, CPU, cost=True, batch=2, sizes=((60, 90), (50, 80)), blob_hw=(64, 96),
        target_size=64, max_size=96, pre=200, post=32, rois_per_image=16, gt_range=(2, 4))
    count = line["count"]
    assert line["device"] == "cpu" and line["batch"] == 2
    assert count["roi_align_calls"] == {"fwd": 2, "bwd": 2}
    assert count["roi_align"]["fwd"] == count["roi_align"]["bwd"] > 0
    assert "aten.convolution_backward" in count["layers_by_op"]
    assert line["flops_per_step"] == count["layers"] + 2 * count["roi_align"]["fwd"]
    assert line["flops_per_image"] == line["flops_per_step"] / 2
    with pytest.raises(NotImplementedError, match="PROFILE_E2E_RPN_STAGE"):
        profile_e2e_train.main({"BENCH_DEVICE": "cpu", "PROFILE_E2E_RPN_STAGE": "const"})


def test_bench_e2e_line(tmp_path):
    cfg = PRESETS["e2e_mask_rcnn_R-50-FPN_2x"].replace(rpn=RPNConfig(60, 16))
    tcfg = pconfig.TestConfig(target_size=48, max_size=64, detections_per_img=4,
                              score_thresh=1e-4, device_preprocess=True, exact_blob_dims=True)
    keep = {}
    line = bench_e2e.run(cfg, tcfg, 4, 2, str(tmp_path / "ds"), CPU, verbose=False,
                         height=48, width=64, keep=keep)
    info = keep["info"]
    assert line["detections"] == len(info["bbox"]) > 0 and line["segms"] == len(info["segm"])
    assert line["images"] == 4 and line["batches"] == 2 and line["device"] == "cpu"
    assert set(line["phase_seconds"]) == {"load", "submit", "finalize"}
    assert line["metric"] == "e2e_evaluate_dataset_throughput"
    assert line["launches"] == {"roi_align_fwd": 0, "roi_align_bwd": 0}
    assert line["weights"] == "init_params(seed 0)"


def test_tools_refuse_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: bench.main({}), lambda: bench.main({"BENCH_MODE": "train"}),
                lambda: profile_e2e_train.main({}), lambda: bench_e2e.main([]),
                lambda: profile_stages.main([]), lambda: profile_mfu.main([])):
        with pytest.raises(RuntimeError, match="runs on the card"):
            run()


def test_mesh_refuses_the_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()
    assert M.make_mesh(device="cpu").device == CPU

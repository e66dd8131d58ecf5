"""The port's inference engines and dataset loop on a tiny synthetic set.

The mechanics of tests/test_engine.py, at 64x96, random weights, on the
CPU: the Fast R-CNN FPN loop, batched against single-image results (host
blob and device preprocessing), target_sizes folding, engine reuse, the
NMS-prefilter rerun, multi-scale inference, and the multi-scale merge
against the JAX engine's merge fed the same per-scale outputs. Results of
two paths of the port are compared as tests/test_engine.py compares them:
the same detections per image, the same classes in score order, boxes
within atol 1e-3 (batch against single; fp32 sums in another order) or
exactly equal masks where the masks are fetched in fp32.
"""

import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.eval import engine as jengine
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.config import PRESETS, KeypointConfig, RPNConfig
from detectorch_tpu_torch.data.coco import CocoDataset
from detectorch_tpu_torch.data.transforms import load_image_rgb
from detectorch_tpu_torch.eval import engine as E
from detectorch_tpu_torch.eval import rle as rle_mod
from detectorch_tpu_torch.models.detector import init_params
from tests.torch_configs import both_configs

H, W = 64, 96
RPN = RPNConfig(pre_nms_top_n=100, post_nms_top_n=20)


def _test_cfg(c):
    """The TestConfig of config module `c`: blobs of 64x96, not the
    832x1344 bucket."""
    return c.TestConfig(target_size=64, max_size=96, detections_per_img=5, score_thresh=0.0,
                        exact_blob_dims=True)


JAX_TCFG, TCFG = both_configs(_test_cfg)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The Tier-1 command runs six pytest workers on the CPU; torch's
    per-op thread pool in each of them oversubscribes the cores and slows
    these runs several-fold. One intra-op thread per worker in this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(preset):
    return PRESETS[preset].replace(compute_dtype="float32", rpn=RPN)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Three 64x96 images, a gt box and polygon each, 80 categories."""
    import cv2

    root = tmp_path_factory.mktemp("tiny")
    rng = np.random.RandomState(0)
    imgs, anns = [], []
    for i in range(3):
        name = f"im{i}.png"
        cv2.imwrite(str(root / name), (rng.uniform(size=(H, W, 3)) * 255).astype(np.uint8))
        imgs.append({"id": i + 1, "file_name": name, "height": H, "width": W})
        anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1 + i,
                     "bbox": [10, 10, 30, 30], "area": 900.0, "iscrowd": 0,
                     "segmentation": [[10, 10, 40, 10, 40, 40, 10, 40]]})
    (root / "ann.json").write_text(json.dumps({
        "images": imgs, "annotations": anns,
        "categories": [{"id": c, "name": f"c{c}"} for c in range(1, 81)],
    }))
    return CocoDataset(str(root / "ann.json"), str(root)), root


@pytest.fixture(scope="module")
def faster_params():
    return params_from_jax(init_params(_cfg("e2e_faster_rcnn_R-50-FPN_2x"), seed=0))


@pytest.fixture(scope="module")
def mask_params():
    params = init_params(_cfg("e2e_mask_rcnn_R-50-FPN_2x"), seed=0)
    # random weights put every mask probability within a bf16 ulp of 0.5;
    # confident logits (as trained weights give) via the bias
    b = params["mask_fcn_logits_b"].copy()
    b[0::2], b[1::2] = 3.0, -3.0
    params["mask_fcn_logits_b"] = b
    return params_from_jax(params)


def _evaluate(cfg, tcfg, params, ds, **kw):
    return E.evaluate_dataset(cfg, tcfg, params, ds, verbose=False, device="cpu", **kw)


def _same_results(a, b, masks=False, atol=1e-3):
    """The same detections per image; in score order the same classes and
    boxes within atol; with masks, the same RLEs."""
    for key in ("bbox", "segm") if masks else ("bbox",):
        ra = sorted(a[key], key=lambda r: (r["image_id"], -r["score"]))
        rb = sorted(b[key], key=lambda r: (r["image_id"], -r["score"]))
        assert len(ra) == len(rb) > 0
        for x, y in zip(ra, rb):
            assert x["image_id"] == y["image_id"] and x["category_id"] == y["category_id"]
            if key == "bbox":
                np.testing.assert_allclose(x["bbox"], y["bbox"], rtol=1e-4, atol=atol)
            else:
                assert x["segmentation"] == y["segmentation"]


def test_detections_to_coco_bbox_matches_jax():
    boxes = np.array([[1.5, 2.0, 10.0, 20.25], [0.0, 0.0, 0.0, 0.0]], np.float32)
    args = (boxes, np.array([0.9, 0.1], np.float32), np.array([3, 80]), 7,
            {i: i + 100 for i in range(81)})
    assert E.detections_to_coco_bbox(*args) == jengine.detections_to_coco_bbox(*args)


def test_fast_rcnn_fpn_eval_loop(tiny, tmp_path):
    ds, _ = tiny
    props = [np.array([[5, 5, 40, 40], [12, 8, 60, 50], [50, 10, 90, 60]], np.float64)] * 3
    pf = tmp_path / "p.pkl"
    with open(pf, "wb") as f:
        pickle.dump({"boxes": props, "ids": [1, 2, 3]}, f)
    roidb = ds.get_roidb(gt=False, proposal_file=str(pf))
    cfg = _cfg("fast_rcnn_R-50-FPN_2x")
    tcfg = TCFG.replace(max_proposals=8)
    params = params_from_jax(init_params(cfg, seed=0))
    bbox_stats, segm_stats, info = _evaluate(cfg, tcfg, params, ds, roidb=roidb)
    assert segm_stats is None and len(bbox_stats) == 12
    assert info["images_per_sec"] > 0 and set(info["phase_seconds"]) == {"load", "submit",
                                                                          "finalize"}
    assert len(info["bbox"]) == 3 * 5
    for r in info["bbox"]:
        assert set(r) == {"image_id", "category_id", "bbox", "score"}
        assert r["category_id"] in ds.contiguous_to_json.values()
    # batched, the same
    _, _, info2 = _evaluate(cfg, tcfg, params, ds, roidb=roidb, batch_size=2)
    _same_results(info, info2)


@pytest.mark.parametrize("device_preprocess", [False, True])
def test_batched_eval_matches_single(tiny, faster_params, device_preprocess):
    ds, _ = tiny
    cfg = _cfg("e2e_faster_rcnn_R-50-FPN_2x")
    tcfg = TCFG.replace(device_preprocess=device_preprocess)
    _, _, single = _evaluate(cfg, tcfg, faster_params, ds)
    _, _, batched = _evaluate(cfg, tcfg, faster_params, ds, batch_size=2)  # tail of 1
    _same_results(single, batched)


def test_device_preprocess_close_to_host_blob(tiny, faster_params):
    ds, _ = tiny
    cfg = _cfg("e2e_faster_rcnn_R-50-FPN_2x")
    eng_h = E.InferenceEngine(cfg, TCFG, faster_params, "cpu")
    eng_d = E.InferenceEngine(cfg, TCFG.replace(device_preprocess=True), faster_params, "cpu")
    im = load_image_rgb(ds.get_roidb()[0].file_path)
    args, oh, ow = eng_d.preprocess(im)
    assert [a.dtype for a in args] == [np.uint8, np.float32, np.float32]
    assert eng_d.sample_key(args) == ((160, 160, 3), (64, 96))
    assert eng_d._scale_of(args) == eng_h._scale_of(eng_h.preprocess(im)[0])
    rh, rd = eng_h.run_image(im), eng_d.run_image(im)
    assert len(rh["scores"]) == len(rd["scores"]) == 5
    np.testing.assert_allclose(rd["scores"], rh["scores"], atol=2e-3)


def test_single_element_target_sizes_folds(tiny, faster_params):
    ds, _ = tiny
    cfg = _cfg("e2e_faster_rcnn_R-50-FPN_2x")
    _, _, via_list = _evaluate(cfg, TCFG, faster_params, ds, target_sizes=[48])
    _, _, via_cfg = _evaluate(cfg, TCFG.replace(target_size=48), faster_params, ds)
    _same_results(via_list, via_cfg, atol=0)


def test_engines_reuse(tiny, faster_params):
    ds, _ = tiny
    cfg = _cfg("e2e_faster_rcnn_R-50-FPN_2x")
    engines = {}
    _evaluate(cfg, TCFG, faster_params, ds, limit=2, batch_size=2, engines=engines)
    batched = engines[("batched", 2)]
    n_programs = len(batched._compiled)
    assert n_programs >= 1
    _, _, info = _evaluate(cfg, TCFG, faster_params, ds, batch_size=2, engines=engines)
    assert engines[("batched", 2)] is batched and len(batched._compiled) == n_programs
    assert len(info["bbox"]) > 0
    # another batch size gets its own engine
    _evaluate(cfg, TCFG, faster_params, ds, limit=3, batch_size=3, engines=engines)
    assert engines[("batched", 3)].batch_size == 3
    with pytest.raises(NotImplementedError):
        E.BatchedInferenceEngine(cfg, TCFG, faster_params, 2, mesh=object(), device="cpu")
    # the keypoint preset, once refused, runs in both engines (a small head:
    # tests/test_torch_kp_engine.py holds them to JAX)
    kcfg = PRESETS["e2e_keypoint_rcnn_R-50-FPN_1x"].replace(
        compute_dtype="float32", rpn=RPN, keypoint=KeypointConfig(num_convs=2, conv_dim=32))
    kparams = params_from_jax(init_params(kcfg, seed=0))
    im = load_image_rgb(ds.get_roidb()[0].file_path)
    res = E.InferenceEngine(kcfg, TCFG, kparams, "cpu").run_image(im)
    assert res["keypoints"].shape == (len(res["boxes"]), 17, 4) and "rles" not in res
    engine = E.BatchedInferenceEngine(kcfg, TCFG, kparams, 2, device="cpu")
    (batched,) = engine.run_batch([engine.preprocess(im)])
    np.testing.assert_allclose(batched["keypoints"], res["keypoints"], rtol=1e-4, atol=1e-3)


def test_batched_mask_fetch_dtypes(tiny, mask_params):
    """With mask_fetch_dtype 'float32' the batched RLEs equal the single
    engine's; the bf16 default may flip pixels within a bf16 ulp of the
    0.5 threshold, never many."""
    ds, _ = tiny
    cfg = _cfg("e2e_mask_rcnn_R-50-FPN_2x")
    _, segm_single, single = _evaluate(cfg, TCFG, mask_params, ds)
    _, _, exact = _evaluate(cfg, TCFG.replace(mask_fetch_dtype="float32"), mask_params, ds,
                            batch_size=2)
    _, _, bf16 = _evaluate(cfg, TCFG, mask_params, ds, batch_size=2)
    assert segm_single is not None and len(segm_single) == 12
    _same_results(single, exact, masks=True)
    s = sorted(single["segm"], key=lambda r: (r["image_id"], -r["score"]))
    b = sorted(bf16["segm"], key=lambda r: (r["image_id"], -r["score"]))
    assert len(s) == len(b)
    for rs, rb in zip(s, b):
        ms, mb = rle_mod.decode(rs["segmentation"]), rle_mod.decode(rb["segmentation"])
        assert ms.shape == (H, W)
        union = np.logical_or(ms, mb).sum()
        if union:
            assert np.logical_and(ms, mb).sum() / union > 0.95


def test_nms_prefilter_overflow_reruns(tiny, faster_params):
    """score_thresh 0 makes every roi a candidate of every class, so the
    prefilter of 16 always overflows: the program flags it and finalize
    reruns the image without it, equal to an engine without prefilter."""
    ds, _ = tiny
    cfg = _cfg("e2e_faster_rcnn_R-50-FPN_2x").replace(rpn=RPNConfig(100, 40))
    im = load_image_rgb(ds.get_roidb()[0].file_path)
    fast = E.InferenceEngine(cfg, TCFG.replace(nms_topk_prefilter=16), faster_params, "cpu")
    assert fast._needs_exact_check()
    args, oh, ow = fast.preprocess(im)
    out = fast.submit(args)
    assert not bool(out.detections.nms_exact[0]) and not bool(out.all_exact[0])
    assert bool(out.roi_align_exact[0])
    res = fast.finalize(out, args, oh, ow)
    ref = E.InferenceEngine(cfg, TCFG, faster_params, "cpu").run_image(im)
    np.testing.assert_array_equal(res["classes"], ref["classes"])
    np.testing.assert_array_equal(res["scores"], ref["scores"])
    np.testing.assert_array_equal(res["boxes"], ref["boxes"])
    # the batched engine reruns the same way, and counts it
    batched = E.BatchedInferenceEngine(cfg, TCFG.replace(nms_topk_prefilter=16),
                                       faster_params, 2, device="cpu")
    (res_b,) = batched.run_batch([(args, oh, ow)])
    assert batched.rerun_count == 1
    np.testing.assert_array_equal(res_b["classes"], ref["classes"])


def test_multiscale_single_size_matches_run_image(tiny, mask_params):
    ds, _ = tiny
    cfg = _cfg("e2e_mask_rcnn_R-50-FPN_2x")
    tcfg = TCFG.replace(device_preprocess=True)
    eng = E.InferenceEngine(cfg, tcfg, mask_params, "cpu")
    im = load_image_rgb(ds.get_roidb()[0].file_path)
    single = eng.run_image(im)
    multi = eng.run_image_multiscale(im, [tcfg.target_size])
    np.testing.assert_array_equal(multi["classes"], single["classes"])
    np.testing.assert_allclose(multi["scores"], single["scores"], rtol=1e-6)
    np.testing.assert_allclose(multi["boxes"], single["boxes"], rtol=1e-5, atol=1e-4)
    assert multi["rles"] == single["rles"]


def test_multiscale_merge_matches_jax(tiny, faster_params):
    """Two sizes: the port's merge and the JAX engine's merge on the same
    per-scale outputs select the same detections."""
    ds, _ = tiny
    cfg = _cfg("e2e_faster_rcnn_R-50-FPN_2x")
    eng = E.InferenceEngine(cfg, TCFG, faster_params, "cpu")
    im = load_image_rgb(ds.get_roidb()[0].file_path)
    outs, scales = [], []
    for ts in (48, 64):
        args, oh, ow = eng.preprocess(im, target_size=ts)
        outs.append(eng.submit(args))
        scales.append(eng._scale_of(args))
    fields = ("cls_scores", "bbox_deltas", "rois", "roi_valid")
    got = eng._merge_fn(2)(*([getattr(o, f) for o in outs] for f in fields),
                           torch.tensor(scales), torch.tensor([float(oh)]),
                           torch.tensor([float(ow)]))
    jcfg, pcfg = both_configs(lambda c: c.PRESETS["e2e_faster_rcnn_R-50-FPN_2x"].replace(
        compute_dtype="float32", rpn=c.RPNConfig(pre_nms_top_n=100, post_nms_top_n=20)))
    assert pcfg == cfg
    jeng = jengine.InferenceEngine(jcfg, JAX_TCFG, {})
    exp = jeng._merge_fn(2)(*([getattr(o, f)[0].numpy() for o in outs] for f in fields),
                            jnp.asarray(scales, jnp.float32), jnp.float32(oh), jnp.float32(ow))
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(exp.valid))
    np.testing.assert_array_equal(got.classes[0].numpy(), np.asarray(exp.classes))
    np.testing.assert_allclose(got.scores[0].numpy(), np.asarray(exp.scores), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.boxes[0].numpy(), np.asarray(exp.boxes), rtol=0, atol=1e-4)
    res = eng.run_image_multiscale(im, [48, 64])
    assert len(res["boxes"]) == int(got.valid.sum()) == 5
    np.testing.assert_array_equal(res["classes"], got.classes[0][got.valid[0]].numpy())


def test_evaluate_dataset_multiscale(tiny, mask_params, tmp_path):
    ds, _ = tiny
    cfg = _cfg("e2e_mask_rcnn_R-50-FPN_2x")
    bbox_stats, segm_stats, info = _evaluate(cfg, TCFG, mask_params, ds, target_sizes=[48, 64],
                                             output_dir=str(tmp_path / "out"))
    assert len(bbox_stats) == 12 and len(segm_stats) == 12
    assert len(info["segm"]) == len(info["bbox"]) == 15
    assert any(p.suffix == ".json" for p in (tmp_path / "out").iterdir())
    with pytest.raises(ValueError):
        _evaluate(cfg, TCFG, mask_params, ds, target_sizes=[48, 64], batch_size=2)

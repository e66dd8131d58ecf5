"""The port's engines and dataset loop on the C4 presets, against the JAX
package's, on a tiny synthetic set (three 64x96 images) on the CPU.

fp32, RPN 100 -> 20, 5 detections per image at score_thresh 0, random
weights with two confident classes and confident masks
(mask_fcn_logits_b +-3, as tests/test_torch_engine.py makes them), so that
the detections are not near-ties of 81 classes. The random C4 trunk has no
FPN neck to bound it: on these images its c4 map reaches ~970 and its res5
features ~800, so cls_score_w is scaled by 1e-3 (logits of std ~0.06, not
~60, which saturate every softmax to 1.0) and classes 1 and 2 get a bias
of 3; the RPN's and the box head's delta weights are scaled by 0.05 and
0.01, so that deltas stay near the magnitudes trained weights give (at
full scale the RPN's reach ~16, and fp32 summation-order drift through
exp() of them moves boxes by 6.5e-3 px). JAX's ``evaluate_dataset`` and
the port's run on the same set and weights; their results are compared as
tests/test_engine.py compares two engines: the same detections per image,
in score order the same classes, boxes within rtol 1e-4 / atol 1e-3 and
equal mask RLEs. Covered: Faster/Mask R-CNN C4 (single and batched engines,
host blob and on-device preprocessing), Fast R-CNN C4 from proposals (the
engine's dedup at 1/16) with soft-NMS and box voting, and multi-scale
inference, whose mask branch runs once through ``make_mask_fn``.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from detectorch_tpu.data.coco import CocoDataset as JaxCocoDataset
from detectorch_tpu.eval import engine as jengine
from detectorch_tpu.models.detector import init_params
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.data.coco import CocoDataset
from detectorch_tpu_torch.eval import engine as E
from tests.torch_configs import both_configs

H, W = 64, 96
MASK, FAST = "e2e_mask_rcnn_R-50-C4_2x", "fast_rcnn_R-50-C4_2x"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(preset):
    return both_configs(lambda c: c.PRESETS[preset].replace(
        compute_dtype="float32", rpn=c.RPNConfig(pre_nms_top_n=100, post_nms_top_n=20)))


def _tcfgs(**kw):
    return both_configs(lambda c: c.TestConfig(
        target_size=64, max_size=96, detections_per_img=5, score_thresh=0.0,
        exact_blob_dims=True, **kw))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Three 64x96 images, a gt box and polygon each, 80 categories, and a
    proposal file."""
    import cv2

    root = tmp_path_factory.mktemp("tiny_c4")
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
    props = []
    for _ in range(3):
        x1, y1 = rng.uniform(0, 60, 12), rng.uniform(0, 40, 12)
        p = np.stack([x1, y1, x1 + rng.uniform(6, 40, 12), y1 + rng.uniform(6, 30, 12)], 1)
        # near-duplicates that the engine's dedup at 1/16 merges
        props.append(np.concatenate([p, p[:3] + 0.25]).astype(np.float64))
    pf = root / "props.pkl"
    with open(pf, "wb") as f:
        pickle.dump({"boxes": props, "ids": [1, 2, 3]}, f)
    return str(root / "ann.json"), str(root), str(pf)


def _params(cfg):
    p = {k: np.asarray(v) for k, v in init_params(cfg, seed=0).items()}
    p["cls_score_w"] = p["cls_score_w"] * np.float32(1e-3)
    p["bbox_pred_w"] = p["bbox_pred_w"] * np.float32(1e-2)
    if "rpn_bbox_pred_w" in p:
        p["rpn_bbox_pred_w"] = p["rpn_bbox_pred_w"] * np.float32(0.05)
    b = p["cls_score_b"].copy()
    b[[1, 2]] = 3.0
    p["cls_score_b"] = b
    if "mask_fcn_logits_b" in p:
        b = p["mask_fcn_logits_b"].copy()
        b[0::2], b[1::2] = 3.0, -3.0
        p["mask_fcn_logits_b"] = b
    return p


def _same_results(a, b, masks=False, atol=1e-3):
    for key in ("bbox", "segm") if masks else ("bbox",):
        ra = sorted(a[key], key=lambda r: (r["image_id"], -r["score"]))
        rb = sorted(b[key], key=lambda r: (r["image_id"], -r["score"]))
        assert len(ra) == len(rb) > 0
        for x, y in zip(ra, rb):
            assert x["image_id"] == y["image_id"] and x["category_id"] == y["category_id"]
            if key == "bbox":
                np.testing.assert_allclose(x["bbox"], y["bbox"], rtol=1e-4, atol=atol)
                np.testing.assert_allclose(x["score"], y["score"], rtol=0, atol=1e-5)
            else:
                assert x["segmentation"] == y["segmentation"]


def _both(preset, tiny, tcfg_kw=None, proposals=False, **kw):
    """JAX's and the port's evaluate_dataset on the tiny set: (stats and
    results of JAX, of the port)."""
    ann, root, pf = tiny
    cfg, pcfg = _cfgs(preset)
    tcfg, ptcfg = _tcfgs(**(tcfg_kw or {}))
    params = _params(cfg)
    jds, pds = JaxCocoDataset(ann, root), CocoDataset(ann, root)
    jroidb = jds.get_roidb(gt=False, proposal_file=pf if proposals else None)
    proidb = pds.get_roidb(gt=False, proposal_file=pf if proposals else None)
    jres = jengine.evaluate_dataset(cfg, tcfg, params, jds, roidb=jroidb, verbose=False, **kw)
    pres = E.evaluate_dataset(pcfg, ptcfg, params_from_jax(params), pds, roidb=proidb,
                              verbose=False, device="cpu", **kw)
    return jres, pres, (pcfg, ptcfg, params_from_jax(params), pds, proidb)


def test_c4_mask_eval_matches_jax(tiny):
    (jb, js, jinfo), (pb, ps, pinfo), (pcfg, ptcfg, params, pds, proidb) = _both(MASK, tiny)
    assert len(pinfo["bbox"]) == len(pinfo["segm"]) == 15
    _same_results(jinfo, pinfo, masks=True)
    np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ps, js, rtol=0, atol=1e-6)
    # the batched engine (a tail of 1) and on-device preprocessing, port
    # against port: masks fetched in fp32 give the same RLEs
    for device_preprocess in (False, True):
        tc = ptcfg.replace(mask_fetch_dtype="float32", device_preprocess=device_preprocess)
        _, _, single = E.evaluate_dataset(pcfg, tc, params, pds, roidb=proidb, verbose=False,
                                          device="cpu")
        _, _, batched = E.evaluate_dataset(pcfg, tc, params, pds, roidb=proidb,
                                           verbose=False, device="cpu", batch_size=2)
        _same_results(single, batched, masks=True)
        if not device_preprocess:
            _same_results(pinfo, single, masks=True)


def test_c4_fast_rcnn_soft_nms_bbox_vote_match_jax(tiny):
    """Fast R-CNN C4 from a proposal file with near-duplicate proposals
    (merged by the engine's dedup at 1/16), soft-NMS and box voting."""
    for kw in ({}, {"soft_nms": True}, {"do_bbox_vote": True}):
        # 16 proposal slots, not the default 1000: res5 runs on every slot
        (jb, _, jinfo), (pb, ps, pinfo), _ = _both(FAST, tiny, proposals=True,
                                                   tcfg_kw={"max_proposals": 16, **kw})
        assert ps is None and len(pinfo["bbox"]) == 15
        _same_results(jinfo, pinfo)
        np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-6)


def test_c4_multiscale_matches_jax(tiny):
    """Two test scales: per-scale C4 programs, the union merge, and the mask
    branch once at the first scale through make_mask_fn."""
    (_, _, jinfo), (_, ps, pinfo), _ = _both(MASK, tiny, target_sizes=[48, 64])
    assert ps is not None and len(pinfo["segm"]) == len(pinfo["bbox"]) == 15
    _same_results(jinfo, pinfo, masks=True)

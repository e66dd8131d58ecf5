"""The port's own copies of the JAX package's host modules, held to their
originals on the same inputs.

The port keeps a copy of every host module it needs under the same relative
path — config, the COCO dataset and roidb, transforms, the prefetch loader,
the roi sampler, RLE, COCOeval, the mask paste, results files, training
stats — so that it runs where the JAX package is absent. Both sides run the
same numpy code, so every result must be equal: integers, strings and float
arrays bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest

from detectorch_tpu import config as jconfig
from detectorch_tpu.data import coco as jcoco
from detectorch_tpu.data import loader as jloader
from detectorch_tpu.data import transforms as jT
from detectorch_tpu.data.synth import build_synth_coco, write_proposals_pkl
from detectorch_tpu.eval import coco_eval as jce
from detectorch_tpu.eval import mask_paste as jmp
from detectorch_tpu.eval import results_io as jrio
from detectorch_tpu.eval import rle as jrle
from detectorch_tpu.train import sampler as jsampler
from detectorch_tpu.utils import stats as jstats
from detectorch_tpu_torch import config as tconfig
from detectorch_tpu_torch.data import coco as tcoco
from detectorch_tpu_torch.data import loader as tloader
from detectorch_tpu_torch.data import transforms as tT
from detectorch_tpu_torch.eval import coco_eval as tce
from detectorch_tpu_torch.eval import mask_paste as tmp
from detectorch_tpu_torch.eval import results_io as trio
from detectorch_tpu_torch.eval import rle as trle
from detectorch_tpu_torch.train import sampler as tsampler
from detectorch_tpu_torch.utils import stats as tstats


def _assert_same(a, b, what=""):
    """Equal values of equal types: arrays bit for bit, containers and
    dataclasses item by item."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (what, a, b)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A small synthetic COCO set (crowd regions, polygons) with a proposal
    file, in a directory of this run."""
    root = str(tmp_path_factory.mktemp("host_copies"))
    ann, imdir = build_synth_coco(root, n_images=4, height=96, width=128, seed=2)
    props = write_proposals_pkl(ann, os.path.join(root, "proposals.pkl"))
    return ann, imdir, props, root


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_presets_equal(preset):
    got, exp = tconfig.PRESETS[preset], jconfig.PRESETS[preset]
    assert type(got).__module__ == "detectorch_tpu_torch.config"
    assert dataclasses.asdict(got) == dataclasses.asdict(exp)


# presets the port has and the JAX package lacks
PORT_ONLY = {"e2e_mask_rcnn_X-101-64x4d-FPN_1x"}


def test_config_defaults_and_constants():
    assert set(jconfig.PRESETS) <= set(tconfig.PRESETS)
    assert set(tconfig.PRESETS) - set(jconfig.PRESETS) == PORT_ONLY
    # ResNeXt-101 differs from the R-101 FPN Mask R-CNN in its trunk alone
    x101 = dataclasses.asdict(tconfig.PRESETS["e2e_mask_rcnn_X-101-64x4d-FPN_1x"])
    r101 = dataclasses.asdict(tconfig.PRESETS["e2e_mask_rcnn_R-101-FPN_2x"])
    assert {k for k in x101 if x101[k] != r101[k]} == {"name", "arch"}
    assert x101["arch"] == "resnext101_64x4d"
    for name in ("TestConfig", "SolverConfig", "SamplerConfig", "RPNConfig", "ModelConfig"):
        assert dataclasses.asdict(getattr(tconfig, name)()) == \
            dataclasses.asdict(getattr(jconfig, name)()), name
    for name in ("BBOX_XFORM_CLIP", "PIXEL_MEANS_BGR"):
        assert getattr(tconfig, name) == getattr(jconfig, name)


def _masks(rng, n, h, w):
    yy, xx = np.mgrid[:h, :w]
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(2, h / 2), rng.uniform(2, w / 2)
        m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        out.append((m | (rng.rand(h, w) > 0.97)).astype(np.uint8))
    out.append(np.zeros((h, w), np.uint8))
    out.append(np.ones((h, w), np.uint8))
    return out


def test_rle_matches(rng):
    masks = _masks(rng, 6, 37, 53)
    enc_t, enc_j = [trle.encode(m) for m in masks], [jrle.encode(m) for m in masks]
    _assert_same(enc_t, enc_j, "encode")
    for e, m in zip(enc_t, masks):
        _assert_same(trle.decode(e), jrle.decode(e), "decode")
        assert np.array_equal(trle.decode(e), m)
        _assert_same(trle.area(e), jrle.area(e), "area")
        _assert_same(trle.to_bbox(e), jrle.to_bbox(e), "to_bbox")
        counts = trle.encode_counts(m)
        _assert_same(counts, jrle.encode_counts(m), "encode_counts")
        _assert_same(trle.counts_to_string(counts), jrle.counts_to_string(counts), "to_string")
        s = trle.counts_to_string(counts)
        _assert_same(trle.string_to_counts(s), jrle.string_to_counts(s), "from_string")
    crowd = [False, True, False, False, True, False, False, False]
    _assert_same(trle.rle_iou(enc_t[:5], enc_t, crowd), jrle.rle_iou(enc_j[:5], enc_j, crowd),
                 "rle_iou")
    _assert_same(trle.merge_union(enc_t[:3]), jrle.merge_union(enc_j[:3]), "merge_union")
    _assert_same(trle.rle_intersection_area(enc_t[0], enc_t[1]),
                 jrle.rle_intersection_area(enc_j[0], enc_j[1]), "intersection")
    poly = [[3.0, 4.0, 30.5, 6.0, 25.0, 30.0, 5.5, 22.0]]
    _assert_same(trle.polygons_to_mask(poly, 37, 53), jrle.polygons_to_mask(poly, 37, 53))
    _assert_same(trle.segmentation_to_rle(poly, 37, 53), jrle.segmentation_to_rle(poly, 37, 53))
    patch = masks[0][5:20, 7:30]
    _assert_same(trle.encode_pasted(patch, 7, 5, 37, 53), jrle.encode_pasted(patch, 7, 5, 37, 53))


def _detections(rng, coco_gt, masks_too):
    """Noisy copies of the gt boxes plus random boxes, COCO result dicts."""
    res = []
    for ann in coco_gt.dataset["annotations"]:
        img = coco_gt.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        for _ in range(2):
            x, y, bw, bh = np.asarray(ann["bbox"], np.float64) + rng.randn(4) * 3
            r = {"image_id": ann["image_id"], "category_id": ann["category_id"],
                 "bbox": [float(x), float(y), float(max(bw, 1)), float(max(bh, 1))],
                 "score": float(rng.uniform(0.05, 1))}
            if masks_too:
                m = np.zeros((h, w), np.uint8)
                x0, y0 = int(max(x, 0)), int(max(y, 0))
                m[y0:int(y + max(bh, 1)), x0:int(x + max(bw, 1))] = 1
                r["segmentation"] = jrle.encode(m)
            res.append(r)
    return res


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_coco_eval_matches(rng, synth, iou_type):
    ann = synth[0]
    gt_t, gt_j = tce.COCO(ann), jce.COCO(ann)
    res = _detections(rng, gt_j, iou_type == "segm")
    evs = []
    for mod, gt in ((tce, gt_t), (jce, gt_j)):
        ev = mod.COCOeval(gt, gt.load_res(res), iou_type)
        ev.evaluate()
        ev.accumulate()
        ev.summarize(verbose=False)
        evs.append(ev)
    assert 0 < evs[1].stats[0] < 1  # a real evaluation
    _assert_same(evs[0].stats, evs[1].stats, "stats")
    _assert_same(evs[0].eval["precision"], evs[1].eval["precision"], "precision")


def test_mask_paste_matches(rng):
    masks = rng.uniform(0, 1, (6, 28, 28)).astype(np.float32)
    x1, y1 = rng.uniform(-20, 90, 6), rng.uniform(-20, 60, 6)
    boxes = np.stack([x1, y1, x1 + rng.uniform(2, 60, 6), y1 + rng.uniform(2, 40, 6)], 1)
    boxes = boxes.astype(np.float32)
    _assert_same(tmp.expand_boxes_np(boxes, 30 / 28), jmp.expand_boxes_np(boxes, 30 / 28))
    for encode in (True, False):
        _assert_same(tmp.segm_results(masks, boxes, 80, 100, 28, encode=encode),
                     jmp.segm_results(masks, boxes, 80, 100, 28, encode=encode),
                     f"segm_results encode={encode}")
    ref = np.array([5, 6, 40, 30], np.int32)
    padded = np.pad(masks[0], 1)
    _assert_same(tmp.paste_mask(padded, ref, 80, 100), jmp.paste_mask(padded, ref, 80, 100))


def test_coco_dataset_and_training_roidb_match(synth):
    ann, imdir, props, _ = synth
    for gt, proposal_file in ((True, None), (False, props), (True, props)):
        got = tcoco.CocoDataset(ann, imdir).get_roidb(gt=gt, proposal_file=proposal_file)
        exp = jcoco.CocoDataset(ann, imdir).get_roidb(gt=gt, proposal_file=proposal_file)
        _assert_same(got, exp, f"roidb gt={gt} proposals={proposal_file is not None}")
    tds, troidb = tcoco.roidb_for_training(ann, imdir, props)
    jds, jroidb = jcoco.roidb_for_training(ann, imdir, props)
    assert len(troidb) == 2 * 4 and all(e.bbox_targets is not None for e in troidb)
    _assert_same(troidb, jroidb, "roidb_for_training")
    _assert_same(tds.classes, jds.classes)
    _assert_same(tds.json_to_contiguous, jds.json_to_contiguous)


@pytest.mark.parametrize("with_targets", [True, False], ids=["targets", "no_targets"])
def test_sample_rois_matches(synth, with_targets):
    """One RandomState per side, with the same seed: the same rois, labels,
    targets and mask targets. Without bbox_targets each sampler encodes its
    own (the port with its ops/boxes)."""
    ann, imdir, props, _ = synth
    _, troidb = tcoco.roidb_for_training(ann, imdir, props)
    _, jroidb = jcoco.roidb_for_training(ann, imdir, props)
    tcfg, jcfg = tconfig.SamplerConfig(rois_per_image=32), jconfig.SamplerConfig(rois_per_image=32)
    for te, je in zip(troidb, jroidb):
        if not with_targets:
            te.bbox_targets = je.bbox_targets = None
        got = tsampler.sample_rois(te, 1.25, np.random.RandomState(3), tcfg, 81,
                                   mask_resolution=28)
        exp = jsampler.sample_rois(je, 1.25, np.random.RandomState(3), jcfg, 81,
                                   mask_resolution=28)
        _assert_same(got, exp, f"sample_rois {te.image_id}")
        assert got["valid"].sum() > 0


def test_transforms_match(rng, synth):
    ann, imdir, _, _ = synth
    name = sorted(os.listdir(imdir))[0]
    im_t = tT.load_image_rgb(os.path.join(imdir, name))
    _assert_same(im_t, jT.load_image_rgb(os.path.join(imdir, name)), "load_image_rgb")
    for h, w in ((96, 128), (480, 640), (1000, 300)):
        assert tT.compute_scale(h, w) == jT.compute_scale(h, w)
        assert tT.bucket_shape(h, w) == jT.bucket_shape(h, w)
    _assert_same(tT.preprocess_image(im_t, 64, 100), jT.preprocess_image(im_t, 64, 100))
    _assert_same(tT.preprocess_image(im_t[..., 0], 80, 128, buckets=None),
                 jT.preprocess_image(im_t[..., 0], 80, 128, buckets=None))
    _assert_same(tT.preprocess_image_pyramid(im_t, [48, 64], 128),
                 jT.preprocess_image_pyramid(im_t, [48, 64], 128))
    props = np.round(rng.uniform(0, 200, (40, 4)) / 4) * 4
    props = np.concatenate([props, props[:10]]).astype(np.float32)
    _assert_same(tT.dedup_proposals(props), jT.dedup_proposals(props))
    _assert_same(tT.pad_proposals(props, 64), jT.pad_proposals(props, 64))


def test_results_io_round_trip(rng, synth, tmp_path):
    ann = synth[0]
    res = _detections(rng, jce.COCO(ann), False)
    for mod, sub in ((trio, "port"), (jrio, "jax")):
        path = mod.results_file_path(str(tmp_path / sub), "bbox", "synth", use_salt=False)
        assert os.path.basename(path) == "bbox_synth_results.json"
        mod.write_results_file(res, path)
        assert mod.load_results_file(path) == res
    ev_t = trio.evaluate_from_results(tce.COCO(ann), res, "bbox", str(tmp_path / "port"),
                                      use_salt=False, verbose=False)
    ev_j = jrio.evaluate_from_results(jce.COCO(ann), res, "bbox", str(tmp_path / "jax"),
                                      use_salt=False, verbose=False)
    _assert_same(ev_t.stats, ev_j.stats, "stats")
    _assert_same(trio.log_per_class_ap(ev_t, verbose=False),
                 jrio.log_per_class_ap(ev_j, verbose=False), "per-class AP")
    assert os.path.exists(tmp_path / "port" / "detection_results.pkl")


def test_training_stats_match(rng):
    got, exp = tstats.TrainingStats(100, log_period=5), jstats.TrainingStats(100, log_period=5)
    for it in range(12):
        losses = {"loss_cls": rng.rand(), "loss_bbox": rng.rand()}
        if it % 2:
            losses["loss"] = rng.rand() * 3
        metrics = {"accuracy": rng.rand()}
        for s in (got, exp):
            s.iter_tic()
            s.update_iter_stats(it, losses, metrics)
            s.iter_toc()
        a, b = got.get_stats(it, 0.01), exp.get_stats(it, 0.01)
        for k in ("time", "eta"):  # wall-clock readings of each side's own timer
            assert k in a and k in b
            del a[k], b[k]
        _assert_same(a, b, f"stats at {it}")


@pytest.mark.parametrize("count,workers,prefetch", [(12, 4, 16), (20, 1, 4)])
def test_prefetch_loader_matches(count, workers, prefetch):
    """Results in submission order, as the original gives them. The
    original can deadlock when more than `prefetch` later items take their
    permits before an earlier one (the copy is repaired, see the next
    test), so it runs where it cannot: the engine's setting (4 workers, 16
    in flight) over fewer items than it prefetches, and one worker."""
    def make(i):
        return i * i

    got = list(tloader.PrefetchLoader(range(count), make, num_workers=workers,
                                      prefetch=prefetch))
    assert got == list(jloader.PrefetchLoader(range(count), make, num_workers=workers,
                                              prefetch=prefetch))
    assert got == [i * i for i in range(count)]


@pytest.mark.parametrize("trial", range(3))
def test_prefetch_loader_slow_first_item_does_not_deadlock(trial):
    """3 workers, 4 in flight, 20 items, the first a 20 ms pure-Python
    computation (it holds the GIL, as a slow decode does) and the rest
    instant: in the original, the workers that finish the later items take
    every permit while the worker of an earlier item waits for one, and the
    consumer waits for that item forever. The copy takes a permit before a
    task, so all items arrive, in order. The loader runs in a daemon thread
    under a timeout, so a deadlock fails the test instead of hanging it."""
    import threading
    import time

    def make(i):
        if i == 0:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.02:
                pass
        return i

    got = []

    def consume():
        got.extend(tloader.PrefetchLoader(range(20), make, num_workers=3, prefetch=4))

    thread = threading.Thread(target=consume, daemon=True)
    thread.start()
    thread.join(timeout=10)
    assert not thread.is_alive(), f"loader deadlocked after {len(got)} of 20 items"
    assert got == list(range(20))


# --- the keypoint halves of data/coco and train/sampler, and data/synth ------


@pytest.fixture(scope="module")
def kp_synth(tmp_path_factory):
    """A person-keypoints set (crowd persons without keypoints among them)."""
    root = str(tmp_path_factory.mktemp("host_copies_kp"))
    ann, imdir = build_synth_coco(root, n_images=6, height=96, width=128, seed=4,
                                  with_keypoints=True, crowd_every=3)
    return ann, imdir


def test_keypoint_dataset_and_roidbs_match(kp_synth):
    """The keypoint metadata, the flip permutation, gt keypoints (int32
    truncation included) on gt and training roidbs, their flip, and the
    keypoint filter; a keypoint roidb flipped without its permutation is
    refused by both."""
    ann, imdir = kp_synth
    tds, jds = tcoco.CocoDataset(ann, imdir), jcoco.CocoDataset(ann, imdir)
    for name in ("keypoints", "keypoint_flip_map", "num_keypoints"):
        _assert_same(getattr(tds, name), getattr(jds, name), name)
    _assert_same(tds.keypoint_flip_perm, jds.keypoint_flip_perm, "keypoint_flip_perm")
    got, exp = tds.get_roidb(gt=True), jds.get_roidb(gt=True)
    _assert_same(got, exp, "roidb")
    assert all(e.gt_keypoints is not None and e.gt_keypoints.shape[1:] == (17, 3) for e in got)
    for require in (False, True):
        tr = tcoco.roidb_for_training(ann, imdir, None, require_keypoints=require)
        jr = jcoco.roidb_for_training(ann, imdir, None, require_keypoints=require)
        _assert_same(tr[1], jr[1], f"roidb_for_training require_keypoints={require}")
    assert any(e.flipped for e in tr[1])
    flipped = tcoco.flip_keypoints(got[0].gt_keypoints, tds.keypoint_flip_perm, got[0].width)
    _assert_same(flipped, jcoco.flip_keypoints(exp[0].gt_keypoints, jds.keypoint_flip_perm,
                                               exp[0].width), "flip_keypoints")
    for mod, roidb in ((tcoco, got), (jcoco, exp)):
        with pytest.raises(ValueError):
            mod.extend_with_flipped_entries(roidb)
    # the keypoint filter drops an entry without a labelled keypoint
    bare = [dataclasses.replace(got[0], gt_keypoints=np.zeros_like(got[0].gt_keypoints))]
    kept = tcoco.filter_for_training(bare + got[1:], require_keypoints=True)
    assert got[0].image_id not in {e.image_id for e in kept}
    assert got[0].image_id in {e.image_id for e in tcoco.filter_for_training(got)}
    _assert_same(kept, jcoco.filter_for_training(
        [dataclasses.replace(exp[0], gt_keypoints=np.zeros_like(exp[0].gt_keypoints))]
        + exp[1:], require_keypoints=True), "filter")


def test_keypoints_to_heatmap_labels_match(rng):
    """Random keypoints and rois, keypoints on the bin edges and on the
    right and bottom roi edges, outside, unlabelled: float64 on both
    sides, equal bit for bit."""
    r, p = 60, 17
    x1, y1 = rng.uniform(0, 80, (2, r))
    rois = np.stack([x1, y1, x1 + rng.uniform(0.5, 90, r), y1 + rng.uniform(0.5, 90, r)], 1)
    k = rng.randint(-2, 59, (r, p))
    kx = rois[:, :1] + k * (rois[:, 2:3] - rois[:, :1]) / 56
    ky = rois[:, 1:2] + k[:, ::-1] * (rois[:, 3:4] - rois[:, 1:2]) / 56
    kx[:, 0], ky[:, 1] = rois[:, 2], rois[:, 3]
    kps = np.stack([kx, ky, rng.randint(0, 3, (r, p))], -1).astype(np.float32)
    for size in (56, 14):
        _assert_same(tsampler.keypoints_to_heatmap_labels(kps, rois, size),
                     jsampler.keypoints_to_heatmap_labels(kps, rois, size), f"size {size}")


def test_sample_rois_with_keypoints_matches(kp_synth):
    """sample_rois on gt-only keypoint roidb entries: kp_labels and kp_valid
    beside the rois, as the trainer's --keypoints draws them."""
    ann, imdir = kp_synth
    _, troidb = tcoco.roidb_for_training(ann, imdir, None, require_keypoints=True)
    _, jroidb = jcoco.roidb_for_training(ann, imdir, None, require_keypoints=True)
    tcfg, jcfg = tconfig.SamplerConfig(rois_per_image=16), jconfig.SamplerConfig(rois_per_image=16)
    for te, je in zip(troidb, jroidb):
        for size in (56, 28):
            got = tsampler.sample_rois(te, 1.25, np.random.RandomState(5), tcfg, 2,
                                       keypoint_heatmap_size=size)
            exp = jsampler.sample_rois(je, 1.25, np.random.RandomState(5), jcfg, 2,
                                       keypoint_heatmap_size=size)
            _assert_same(got, exp, f"sample_rois {te.image_id} size {size}")
            assert got["kp_labels"].shape == (16, 17) and got["kp_valid"][:4].any()


@pytest.mark.parametrize("with_keypoints", [False, True], ids=["instances", "keypoints"])
def test_synth_builder_matches(tmp_path, with_keypoints):
    """data/synth: byte-identical annotations, images and proposal files
    from the same arguments; the same class names."""
    from detectorch_tpu.utils import dummy_datasets as jdummy
    from detectorch_tpu_torch.data import synth as tsynth
    from detectorch_tpu_torch.utils import dummy_datasets as tdummy

    out = {}
    for side, build, props in (("port", tsynth.build_synth_coco, tsynth.write_proposals_pkl),
                               ("jax", build_synth_coco, write_proposals_pkl)):
        root = str(tmp_path / side)
        ann, imdir = build(root, n_images=3, height=64, width=80, seed=9,
                           with_keypoints=with_keypoints)
        assert build(root, n_images=3, height=64, width=80, seed=9,
                     with_keypoints=with_keypoints) == (ann, imdir)  # reused
        pkl = props(ann, os.path.join(root, "props.pkl"))
        files = {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
                 for d, _, fs in os.walk(root) for f in fs}
        out[side] = files
        assert os.path.basename(pkl) in files
    assert out["port"] == out["jax"] and len(out["port"]) == 3 + 3
    _assert_same(tsynth.COCO_JSON_IDS, jsynth_ids())
    _assert_same(tsynth.COCO_PERSON_KEYPOINTS, jsynth_keypoints())
    _assert_same(tdummy.COCO_CLASSES, jdummy.COCO_CLASSES)
    assert tdummy.get_coco_dataset().num_classes == jdummy.get_coco_dataset().num_classes == 81


def jsynth_ids():
    from detectorch_tpu.data import synth

    return synth.COCO_JSON_IDS


def jsynth_keypoints():
    from detectorch_tpu.data import synth

    return synth.COCO_PERSON_KEYPOINTS

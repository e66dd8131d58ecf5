"""The port's probe-weight fit (``tools/probe_weights``) against the AP
harness's (``tests/ap_harness.py``), which stays the reference.

  * the synthetic sets it builds equal the harness's, file for file;
  * the helpers and the four probe trainers, copied verbatim, give the
    harness's outputs bit for bit on the same inputs;
  * the features it fits on, computed by the port's modules (the backbone,
    the RPN's hidden activation, RoIAlign and the box head, the mask and
    keypoint trunks), equal the harness mirror's on one image at full width
    within FEAT_REL of the mirror's largest magnitude;
  * ``rpn_head`` without ``return_hidden`` is unchanged.

The whole fit, and its weights through JAX's and the port's
``evaluate_dataset``, are held in tests/test_torch_ap_parity.py.
"""

import os

import numpy as np
import pytest
import torch

from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.models import rpn as trpn
from detectorch_tpu_torch.tools import probe_weights as PW
from tests import ap_harness as AH
from tests import torch_mirror as TM

# fp32 features through ~50 layers, two implementations (NHWC channels_last
# oneDNN convolutions and the plain RoIAlign against NCHW convolutions and
# the numpy float64 RoIAlign): max |d| <= FEAT_REL * max |mirror|
FEAT_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Both synthetic sets, built by the port and by the harness in
    directories of their own: {kind: (port dataset, harness dataset, port
    root, harness root)}."""
    root = tmp_path_factory.mktemp("probe_sets")
    out = {}
    for kind in ("coco", "keypoints"):
        p_root, h_root = str(root / f"port_{kind}"), str(root / f"harness_{kind}")
        if kind == "coco":
            out[kind] = (PW.prepare_dataset(p_root)[0], AH.prepare_dataset(h_root)[0],
                         p_root, h_root)
        else:
            out[kind] = (PW.prepare_keypoint_dataset(p_root),
                         AH.prepare_keypoint_dataset(h_root), p_root, h_root)
    return out


def _files(root):
    found = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                found[os.path.relpath(path, root)] = f.read()
    return found


@pytest.mark.parametrize("kind", ["coco", "keypoints"])
def test_synthetic_sets_equal_the_harness(sets, kind):
    _, _, p_root, h_root = sets[kind]
    ours, theirs = _files(p_root), _files(h_root)
    assert sorted(ours) == sorted(theirs)
    assert len(ours) >= (24 if kind == "coco" else 16)
    assert [n for n in ours if ours[n] != theirs[n]] == []


def test_configs_and_families_equal_the_harness():
    import dataclasses

    for preset in PW.PRESETS:
        assert PW.family_of(preset) == AH.family_of(preset)
        for shapes in ("harness", "production"):
            ours, theirs = PW.harness_cfg(preset, shapes), AH.harness_cfg(preset, shapes)
            assert [dataclasses.asdict(c) for c in ours] == [dataclasses.asdict(c) for c in theirs]
    assert PW.FAMILY_PRESET == AH.FAMILY_PRESET


def test_helpers_equal_the_harness(sets):
    port_ds, harness_ds, _, _ = sets["coco"]
    entries = zip(port_ds.get_roidb(gt=True)[:4], harness_ds.get_roidb(gt=True)[:4])
    for i, (pe, he) in enumerate(entries):
        scale = 256.0 / 224.0
        a = PW._probe_rois(pe, scale, np.random.RandomState(i))
        b = AH._probe_rois(he, scale, np.random.RandomState(i))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        rois, _, _, gt, gt_cls = a
        for x, y in zip(PW._label_by_iou(rois, gt, gt_cls), AH._label_by_iou(rois, gt, gt_cls)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(PW._bbox_targets(rois[:len(gt)], gt),
                                      AH._bbox_targets(rois[:len(gt)], gt))
        for g in range(len(gt)):
            np.testing.assert_array_equal(PW._mask_target(pe, g, gt[g] / scale, 28),
                                          AH._mask_target(he, g, gt[g] / scale, 28))
    params = {"a_bn_s": np.ones(5, np.float32), "a_branch2c_bn_s": np.zeros(5, np.float32),
              "a_bn_b": np.zeros(5, np.float32), "a_w": np.ones((1, 1, 2, 5), np.float32)}
    ours = PW._perturb_bn(dict(params), np.random.RandomState(3))
    theirs = AH._perturb_bn(dict(params), np.random.RandomState(3))
    assert list(ours) == list(theirs)
    assert all(np.array_equal(ours[k], theirs[k]) for k in ours)


def _trainer_case(name, rng):
    """Small numpy features and labels for one trainer, and its arguments."""
    if name == "rpn":
        hidden = rng.randn(600, 16).astype(np.float32)
        labels = (rng.rand(600, 3) < 0.1).astype(np.float32)
        return (hidden, labels)
    if name == "box":
        feats = np.abs(rng.randn(200, 32)).astype(np.float32)
        labels = rng.randint(0, 5, 200).astype(np.int64)
        tgts = rng.randn(200, 4).astype(np.float32)
        return (feats, labels, tgts, {"cls_score_w": np.zeros((5, 32), np.float32)},
                np.random.RandomState(0))
    if name == "mask":
        feats = np.abs(rng.randn(6, 8, 7, 7)).astype(np.float32)
        tgts = (rng.rand(6, 7, 7) < 0.4).astype(np.float32)
        return (feats, tgts, rng.randint(0, 5, 6),
                {"mask_fcn_logits_w": np.zeros((1, 1, 8, 5), np.float32)})
    feats = np.abs(rng.randn(4, 8, 14, 14)).astype(np.float32)
    bins = rng.randint(0, 56 * 56, (4, 3)).astype(np.int32)
    vis = rng.rand(4, 3) < 0.8
    return (feats, bins, vis, {"kps_score_lowres_w": np.zeros((8, 3, 4, 4), np.float32)})


@pytest.mark.parametrize("name", ["rpn", "box", "mask", "kp"])
def test_trainers_bitwise_equal_the_harness(name):
    fn = {"rpn": "_train_rpn_probe", "box": "_train_box_probes", "mask": "_train_mask_probe",
          "kp": "_train_kp_probe"}[name]
    ours = getattr(PW, fn)(*_trainer_case(name, np.random.RandomState(5)))
    theirs = getattr(AH, fn)(*_trainer_case(name, np.random.RandomState(5)))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert any(np.abs(a).max() > 0 for a in ours)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max()
    assert err <= FEAT_REL * scale, f"{what}: max|d| {err:.3g} of max|mirror| {scale:.3g}"


@pytest.mark.parametrize("family", ["r50_fpn", "r50_c4", "r50_fpn_kp"])
def test_features_equal_the_mirror(sets, family):
    """One image's features, the port's modules against the mirror's, on
    the fit's starting weights (``start_params``: init_params, perturbed BN,
    damped RPN regression): backbone levels, each RPN level's hidden
    activation, the box head on the image's probe rois, and the mask or
    keypoint trunk on its gt boxes."""
    port_ds, harness_ds, _, _ = sets["keypoints" if family == "r50_fpn_kp" else "coco"]
    cfg, tcfg = PW.harness_cfg(PW.FAMILY_PRESET[family])
    seed = PW.FAMILY_SEED[family]
    params = PW.start_params(cfg, seed, np.random.RandomState(seed))
    tparams = params_from_jax(params)
    pe, he = port_ds.get_roidb(gt=True)[1], harness_ds.get_roidb(gt=True)[1]
    im = PW.T.load_image_rgb(pe.file_path)
    image, scale, _ = PW.T.preprocess_image(
        im, tcfg.target_size, tcfg.max_size,
        pad_stride=cfg.fpn.coarsest_stride if cfg.use_fpn else 32, buckets=None)

    with torch.inference_mode():
        feats, levels = PW.backbone_rpn_levels(cfg, tparams, image, torch.device("cpu"))
    backbone, mirror_levels = AH._backbone_rpn_levels(cfg, params, image)
    if cfg.use_fpn:
        for i, (p, m) in enumerate(zip(feats, backbone)):
            _close(p[0].numpy(), m, f"P{i + 2}")
    else:
        _close(feats[0].numpy(), backbone.transpose(1, 2, 0), "c4")
    assert len(levels) == len(mirror_levels)
    for (hidden, fh, fw, stride, sizes), (m_hid, m_stride, m_sizes) in zip(levels, mirror_levels):
        assert (stride, tuple(sizes)) == (m_stride, tuple(m_sizes))
        c = m_hid.shape[0]
        _close(hidden, m_hid.reshape(c, fh * fw).T, f"RPN hidden at stride {stride}")

    rois, _, _, gt, _ = PW._probe_rois(pe, scale, np.random.RandomState(0))
    with torch.inference_mode():
        ours = PW.box_feats(cfg, tparams, feats, rois)
    _close(ours, AH._box_feats(cfg, params, backbone, rois), "box features")
    if cfg.use_mask:
        with torch.inference_mode():
            ours = PW.mask_trunk_feats(cfg, tparams, feats, gt)
        _close(ours, AH._mask_trunk_feats(cfg, params, backbone, gt), "mask trunk")
    if cfg.keypoint is not None:
        with torch.inference_mode():
            ours = PW.kp_trunk_feats(cfg, tparams, feats, gt)
        _close(ours, AH._kp_trunk_feats(cfg, params, backbone, gt), "keypoint trunk")
    assert he.file_path.endswith(os.path.basename(pe.file_path))


def test_rpn_head_return_hidden():
    params = trpn.init_rpn_params(in_channels=16, num_anchors=3, prefix="_fpn2", seed=4)
    for k in params:
        params[k] = params[k] + np.random.RandomState(1).randn(*params[k].shape).astype(
            np.float32) * 0.1
    x = np.random.RandomState(2).randn(1, 8, 10, 16).astype(np.float32)
    tp = params_from_jax(params)
    plain = trpn.rpn_head(tp, torch.from_numpy(x), prefix="_fpn2")
    cls, bbox, hidden = trpn.rpn_head(tp, torch.from_numpy(x), prefix="_fpn2",
                                      return_hidden=True)
    assert len(plain) == 2
    assert torch.equal(plain[0], cls) and torch.equal(plain[1], bbox)
    logits = trpn.rpn_head(tp, torch.from_numpy(x), prefix="_fpn2", return_logits=True)
    assert torch.equal(torch.sigmoid(logits[0]), plain[0]) and torch.equal(logits[1], plain[1])
    m_cls, m_bbox, m_hid = TM.rpn_head(params, torch.from_numpy(x).permute(0, 3, 1, 2),
                                       "_fpn2", return_hidden=True)
    assert hidden.shape == (1, 8, 10, 16)
    _close(hidden.numpy(), m_hid.permute(0, 2, 3, 1).numpy(), "hidden")
    _close(cls.numpy(), m_cls.permute(0, 2, 3, 1).numpy(), "cls")

"""Confident probe weights for the port's AP studies, fitted over the port's
own forward.

The port's counterpart of the AP harness's probe-weight construction
(``tests/ap_harness.py``): random ``init_params(seed)`` with perturbed
frozen-BN affines and a damped RPN regression, whose terminal predictors
(``rpn_cls_logits``, ``cls_score``/``bbox_pred``, ``mask_fcn_logits``,
``kps_score_lowres``) are fitted as linear probes on the frozen features of
the synthetic COCO sets of ``data/synth``. Scores come out confident,
spread and tie-free, so the AP of a detector run with them means something.

The harness computes its features with a torch + numpy mirror of the
reference pipeline; here they come from the port's modules, run in fp32 on
`device`: the backbone (``resnet.multilevel_body`` + ``fpn.fpn_neck``, or
``resnet.c4_body``), the RPN's hidden activation (``rpn.rpn_head(...,
return_hidden=True)``), the proposals (``detector.rpn_proposals``), RoIAlign
(``detector.roi_features``: the CUDA kernel on the card, the plain version
on the CPU) and the heads' trunks (``detector.box_head``,
``heads.mask_trunk``, ``heads.keypoint_trunk``). On the card TF32 is off for
convolutions and matmuls. Everything downstream of the features (the probe
rois and labels, the targets and the four trainers, with their seeds, step
counts, temperature rescales and numpy RandomState order) is the harness's
code, copied verbatim: on the same features it gives the same weights bit
for bit. Weights are data: the card may fit its own, and
``tests/test_torch_probe_weights.py`` holds the CPU fit's pieces to the
harness.

``make_probe_weights`` returns the weights as the harness does, a
``{blob: numpy array}`` dict in the JAX package's layout (HWIO convs;
``checkpoint.convert.params_from_jax`` turns it into port tensors), and
caches it as a pickle beside the dataset.
"""

from __future__ import annotations

import contextlib
import os
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from detectorch_tpu_torch.checkpoint.convert import params_from_jax, params_to_device
from detectorch_tpu_torch.config import PRESETS, RPNConfig, TestConfig
from detectorch_tpu_torch.data import transforms as T
from detectorch_tpu_torch.data.coco import CocoDataset
from detectorch_tpu_torch.data.synth import build_synth_coco, write_proposals_pkl
from detectorch_tpu_torch.eval import rle as rle_mod
from detectorch_tpu_torch.models import detector
from detectorch_tpu_torch.models import heads as heads_mod
from detectorch_tpu_torch.models.rpn import rpn_head
from detectorch_tpu_torch.ops.anchors import shifted_anchors
from detectorch_tpu_torch.train.sampler import keypoints_to_heatmap_labels

# under the checkout's build/, which .gitignore lists
DEFAULT_ROOT = str(Path(__file__).resolve().parents[2] / "build" / "ap_synth")

# the harness's reduced proposal counts (both pipelines use the same values)
C4_RPN = RPNConfig(pre_nms_top_n=600, post_nms_top_n=150)
FPN_RPN = RPNConfig(pre_nms_top_n=300, post_nms_top_n=100)

HARNESS_TCFG = TestConfig(
    target_size=256, max_size=320, exact_blob_dims=True, max_proposals=256
)

# production shapes: the reference's test-time resize, counts and caps
PRODUCTION_TCFG = TestConfig(
    target_size=800, max_size=1333, exact_blob_dims=True, max_proposals=1000
)

FAMILY_PRESET = {
    "r50_c4": "e2e_mask_rcnn_R-50-C4_2x",
    "r50_fpn": "e2e_mask_rcnn_R-50-FPN_2x",
    "r101_fpn": "e2e_mask_rcnn_R-101-FPN_2x",
    # keypoint family: 2-class (person) head probes + KRCNN deconv probe,
    # trained on the person-keypoints synthetic set
    "r50_fpn_kp": "e2e_keypoint_rcnn_R-50-FPN_1x",
}

FAMILY_SEED = {"r50_c4": 101, "r50_fpn": 202, "r101_fpn": 303, "r50_fpn_kp": 404}


def harness_cfg(preset: str, shapes: str = "harness"):
    """(ModelConfig, TestConfig) of the AP studies: fp32 compute and exact
    RoIAlign; harness shapes (256/320, reduced RPN counts) or production
    shapes (800/1333, the preset's RPN counts)."""
    if shapes == "production":
        cfg = PRESETS[preset].replace(compute_dtype="float32", roi_align_precision="highest")
        return cfg, PRODUCTION_TCFG
    if shapes != "harness":
        raise ValueError(f"shapes must be 'harness' or 'production', got {shapes!r}")
    cfg = PRESETS[preset].replace(
        compute_dtype="float32",
        roi_align_precision="highest",
        rpn=FPN_RPN if PRESETS[preset].use_fpn else C4_RPN,
    )
    return cfg, HARNESS_TCFG


def prepare_dataset(root: str = DEFAULT_ROOT, n_images: int = 24):
    """The synthetic COCO set of the AP studies (224x288, seed 5) and its
    Fast R-CNN proposals file: (CocoDataset, proposals path)."""
    ann, imdir = build_synth_coco(root, n_images=n_images, height=224, width=288, seed=5)
    props = os.path.join(root, "proposals.pkl")
    if not os.path.exists(props):
        write_proposals_pkl(ann, props)
    return CocoDataset(ann, imdir), props


def prepare_keypoint_dataset(root: str = DEFAULT_ROOT + "_kp", n_images: int = 16):
    """The person-keypoints synthetic set of the keypoint preset (seed 6)."""
    ann, imdir = build_synth_coco(root, n_images=n_images, height=224, width=288, seed=6,
                                  with_keypoints=True)
    return CocoDataset(ann, imdir)


def family_of(preset: str) -> str:
    cfg = PRESETS[preset]
    if cfg.keypoint is not None:
        return "r50_fpn_kp"
    return ("r101_" if cfg.arch == "resnet101" else "r50_") + (
        "fpn" if cfg.use_fpn else "c4"
    )


@contextlib.contextmanager
def no_tf32():
    """fp32 convolutions and matmuls in full fp32 on the card (cuDNN's TF32
    default off too), restored on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# probe rois, labels and targets: tests/ap_harness.py's, verbatim
# ---------------------------------------------------------------------------

def _perturb_bn(params, rng):
    for k in list(params):
        if k.endswith("_bn_s") and not k.endswith("branch2c_bn_s"):
            params[k] = rng.uniform(0.8, 1.2, params[k].shape).astype(np.float32)
        if k.endswith("_bn_b"):
            params[k] = (rng.randn(*params[k].shape) * 0.02).astype(np.float32)
    return params


def _probe_rois(entry, scale, rng, jitters=4, randoms=24):
    """Training rois (network-input coords) + labels + gt index per roi."""
    gt = entry.boxes[entry.gt_classes > 0] * scale
    gt_cls = entry.gt_classes[entry.gt_classes > 0]
    rois, labels, gti = [], [], []
    for i, (b, c) in enumerate(zip(gt, gt_cls)):
        w, h = b[2] - b[0], b[3] - b[1]
        rois.append(b); labels.append(c); gti.append(i)
        for _ in range(jitters):
            j = b + rng.randn(4) * np.array([w, h, w, h]) * 0.08
            rois.append(j); labels.append(c); gti.append(i)
    H = entry.height * scale
    W = entry.width * scale
    for _ in range(randoms):
        x1 = rng.uniform(0, W * 0.7); y1 = rng.uniform(0, H * 0.7)
        b = np.array([x1, y1, x1 + rng.uniform(10, W * 0.5),
                      y1 + rng.uniform(10, H * 0.5)])
        # label by IoU vs gt
        lab, gidx = 0, -1
        if len(gt):
            xx1 = np.maximum(b[0], gt[:, 0]); yy1 = np.maximum(b[1], gt[:, 1])
            xx2 = np.minimum(b[2], gt[:, 2]); yy2 = np.minimum(b[3], gt[:, 3])
            inter = np.maximum(0, xx2 - xx1 + 1) * np.maximum(0, yy2 - yy1 + 1)
            areas = ((gt[:, 2] - gt[:, 0] + 1) * (gt[:, 3] - gt[:, 1] + 1)
                     + (b[2] - b[0] + 1) * (b[3] - b[1] + 1) - inter)
            iou = inter / areas
            k = int(iou.argmax())
            if iou[k] >= 0.5:
                lab, gidx = int(gt_cls[k]), k
        rois.append(b); labels.append(lab); gti.append(gidx)
    rois = np.asarray(rois, np.float64)
    rois[:, [0, 2]] = np.clip(rois[:, [0, 2]], 0, W - 1)
    rois[:, [1, 3]] = np.clip(rois[:, [1, 3]], 0, H - 1)
    return rois, np.asarray(labels, np.int64), np.asarray(gti), gt, gt_cls


def _label_by_iou(props, gt, gt_cls, fg_thresh=0.5):
    """Label proposals by best-IoU gt (Fast R-CNN fg rule)."""
    labels = np.zeros(len(props), np.int64)
    gti = -np.ones(len(props), np.int64)
    if len(gt) == 0 or len(props) == 0:
        return labels, gti
    xx1 = np.maximum(props[:, None, 0], gt[None, :, 0])
    yy1 = np.maximum(props[:, None, 1], gt[None, :, 1])
    xx2 = np.minimum(props[:, None, 2], gt[None, :, 2])
    yy2 = np.minimum(props[:, None, 3], gt[None, :, 3])
    inter = np.maximum(0, xx2 - xx1 + 1) * np.maximum(0, yy2 - yy1 + 1)
    a_p = (props[:, 2] - props[:, 0] + 1) * (props[:, 3] - props[:, 1] + 1)
    a_g = (gt[:, 2] - gt[:, 0] + 1) * (gt[:, 3] - gt[:, 1] + 1)
    iou = inter / (a_p[:, None] + a_g[None, :] - inter)
    best = iou.argmax(axis=1)
    best_iou = iou.max(axis=1)
    fg = best_iou >= fg_thresh
    labels[fg] = gt_cls[best[fg]]
    gti[fg] = best[fg]
    return labels, gti


def _mask_target(entry, gt_index, box, M):
    """Gt polygon -> full mask -> crop to (rounded) box -> resize to MxM."""
    import cv2

    gt_rows = np.where(entry.gt_classes > 0)[0]
    segm = entry.segms[gt_rows[gt_index]]
    full = rle_mod.decode(
        rle_mod.segmentation_to_rle(segm, entry.height, entry.width)
    )
    x1, y1, x2, y2 = [int(round(v)) for v in box]
    x1 = max(x1, 0); y1 = max(y1, 0)
    x2 = min(x2, entry.width - 1); y2 = min(y2, entry.height - 1)
    crop = full[y1:y2 + 1, x1:x2 + 1].astype(np.float32)
    if crop.size == 0:
        crop = np.zeros((2, 2), np.float32)
    return (cv2.resize(crop, (M, M)) > 0.5).astype(np.float32)


def _bbox_targets(rois, gt, weights=(10.0, 10.0, 5.0, 5.0)):
    ws = rois[:, 2] - rois[:, 0] + 1.0
    hs = rois[:, 3] - rois[:, 1] + 1.0
    cx = rois[:, 0] + 0.5 * ws
    cy = rois[:, 1] + 0.5 * hs
    gws = gt[:, 2] - gt[:, 0] + 1.0
    ghs = gt[:, 3] - gt[:, 1] + 1.0
    gcx = gt[:, 0] + 0.5 * gws
    gcy = gt[:, 1] + 0.5 * ghs
    wx, wy, ww, wh = weights
    return np.stack([
        wx * (gcx - cx) / ws, wy * (gcy - cy) / hs,
        ww * np.log(gws / ws), wh * np.log(ghs / hs),
    ], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# the four probe trainers: tests/ap_harness.py's, verbatim (plain torch on
# numpy features, on the CPU)
# ---------------------------------------------------------------------------

def _train_rpn_probe(hidden, labels, steps=300):
    """Logistic objectness probe: hidden (P, C) -> labels (P, A)."""
    x = torch.from_numpy(hidden).float()
    y = torch.from_numpy(labels).float()
    torch.manual_seed(11)
    n_anchor = y.shape[1]
    w = torch.zeros(n_anchor, x.shape[1], requires_grad=True)
    b = torch.zeros(n_anchor, requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=1e-2)
    s = float(x.std() + 1e-6)
    xn = x / s
    pos_weight = (y.numel() - y.sum()).clamp(min=1.0) / y.sum().clamp(min=1.0)
    for _ in range(steps):
        opt.zero_grad()
        logits = F.linear(xn, w, b)
        loss = F.binary_cross_entropy_with_logits(
            logits, y, pos_weight=pos_weight.clamp(max=100.0)
        )
        loss.backward()
        opt.step()
    # Temperature-rescale so logits stay out of sigmoid saturation: saturated
    # scores collapse to fp32 ties, making the proposal ORDER sensitive to
    # cross-backend float noise (the exact failure mode this harness must not
    # manufacture — real weights aren't this confident on 8 shape classes).
    with torch.no_grad():
        q = torch.quantile(F.linear(xn, w, b).abs().flatten(), 0.999)
        lam = float(4.0 / q.clamp(min=4.0))
    # store as a 1x1 conv in the framework's HWIO (1, 1, C, A) layout
    w_hwio = (w * lam / s).detach().numpy().astype(np.float32)
    return w_hwio.T[None, None], (b * lam).detach().numpy().astype(np.float32)


def _train_box_probes(feats, labels, tgts, params, rng, steps=400):
    x = torch.from_numpy(feats).float()
    y = torch.from_numpy(labels)
    t = torch.from_numpy(tgts).float()
    d = x.shape[1]
    n_cls = params["cls_score_w"].shape[0]
    torch.manual_seed(7)
    cls_w = torch.zeros(n_cls, d, requires_grad=True)
    cls_b = torch.zeros(n_cls, requires_grad=True)
    bbox_w = torch.zeros(4 * n_cls, d, requires_grad=True)
    bbox_b = torch.zeros(4 * n_cls, requires_grad=True)
    opt = torch.optim.Adam([cls_w, cls_b, bbox_w, bbox_b], lr=5e-3)
    pos = y > 0
    col = (y[pos, None] * 4 + torch.arange(4)[None, :]).long()
    xn = x / (x.std() + 1e-6)
    for _ in range(steps):
        opt.zero_grad()
        logits = F.linear(xn, cls_w, cls_b)
        loss = F.cross_entropy(logits, y)
        deltas = F.linear(xn[pos], bbox_w, bbox_b)
        picked = torch.gather(deltas, 1, col)
        loss = loss + F.smooth_l1_loss(picked, t[pos])
        loss.backward()
        opt.step()
    # Temperature-rescale the classifier out of softmax saturation (see
    # _train_rpn_probe): saturated probs tie in fp32 and make the detection
    # order noise-sensitive.
    with torch.no_grad():
        q = torch.quantile(F.linear(xn, cls_w, cls_b).abs().flatten(), 0.999)
        lam = float(6.0 / q.clamp(min=6.0))
    # fold the feature normalisation into the weights
    s = float(x.std() + 1e-6)
    return (
        (cls_w * lam / s).detach().numpy().astype(np.float32),
        (cls_b * lam).detach().numpy().astype(np.float32),
        (bbox_w / s).detach().numpy().astype(np.float32),
        bbox_b.detach().numpy().astype(np.float32),
    )


def _train_mask_probe(mfeats, mtgts, mcls, params, steps=250):
    """Train mask_fcn_logits (1x1 conv 256->C) on gt-class channels."""
    x = torch.from_numpy(mfeats).float()           # (K, 256, M, M)
    t = torch.from_numpy(mtgts).float()            # (K, M, M)
    n_cls = params["mask_fcn_logits_w"].shape[-1]
    torch.manual_seed(9)
    w = torch.zeros(n_cls, x.shape[1], 1, 1, requires_grad=True)
    b = torch.zeros(n_cls, requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=1e-2)
    s = float(x.std() + 1e-6)
    xn = x / s
    idx = torch.from_numpy(mcls).long()
    for _ in range(steps):
        opt.zero_grad()
        logits = F.conv2d(xn, w, b)                # (K, C, M, M)
        picked = logits[torch.arange(len(idx)), idx]
        loss = F.binary_cross_entropy_with_logits(picked, t)
        loss.backward()
        opt.step()
    # store in the framework's HWIO (1, 1, 256, C) layout
    w_hwio = (w / s).detach().numpy().astype(np.float32)
    w_hwio = w_hwio.transpose(2, 3, 1, 0)
    return w_hwio, b.detach().numpy().astype(np.float32)


def _train_kp_probe(kfeats, bins, vis, params, steps=300):
    """Train kps_score_lowres (4x4/2 deconv 512->P) on mirror trunk
    activations with per-keypoint spatial cross-entropy to the 56x56 gt
    heatmap bins (the trunk stays at its random init, exactly like the
    mask probe trains only mask_fcn_logits)."""
    x = torch.from_numpy(kfeats).float()               # (K, 512, 14, 14)
    n_kp = params["kps_score_lowres_w"].shape[1]
    torch.manual_seed(13)
    w = torch.zeros(x.shape[1], n_kp, 4, 4, requires_grad=True)
    b = torch.zeros(n_kp, requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=1e-2)
    s = float(x.std() + 1e-6)
    xn = x / s
    idx = torch.from_numpy(bins).long()                # (K, P)
    msk = torch.from_numpy(vis)                        # (K, P) bool
    f = torch.tensor([0.25, 0.75, 0.75, 0.25])
    kb = torch.outer(f, f)[None, None].repeat(n_kp, 1, 1, 1)

    def logits56(weight, bias):
        lo = F.conv_transpose2d(xn, weight, bias, stride=2, padding=1)
        hi = F.conv_transpose2d(lo, kb, stride=2, padding=1, groups=n_kp)
        return hi.flatten(2)                           # (K, P, 3136)

    for _ in range(steps):
        opt.zero_grad()
        lg = logits56(w, b)
        nll = F.cross_entropy(
            lg.reshape(-1, lg.shape[-1]), idx.reshape(-1), reduction="none"
        ).reshape(idx.shape)
        loss = (nll * msk).sum() / msk.sum().clamp(min=1)
        loss.backward()
        opt.step()
    # Temperature-rescale out of softmax saturation (see _train_rpn_probe):
    # saturated per-bin logits tie in fp32 and make the ARGMAX bin order
    # sensitive to cross-backend conv noise.
    with torch.no_grad():
        q = torch.quantile(logits56(w, b).abs().flatten(), 0.999)
        lam = float(4.0 / q.clamp(min=4.0))
    return (
        (w * lam / s).detach().numpy().astype(np.float32),  # native layout
        (b * lam).detach().numpy().astype(np.float32),
    )


# ---------------------------------------------------------------------------
# features: the port's modules, fp32, on the caller's device
# ---------------------------------------------------------------------------

def _numpy(x):
    return x.detach().float().cpu().numpy()


def _nchw(x):
    """NHWC tensor -> NCHW numpy, the layout the harness's trainers read."""
    return np.ascontiguousarray(_numpy(x).transpose(0, 3, 1, 2))


def backbone_rpn_levels(cfg, params, image, device):
    """The backbone on one (H, W, 3) fp32 blob and the RPN's hidden
    activation on each of its levels. Returns (feats, levels): feats the
    NHWC pyramid [P2..P5] (FPN) or the c4 map, batch 1, on `device`;
    levels a list of (hidden (fh*fw, C) numpy in (h, w) order, fh, fw,
    stride, anchor sizes), P2..P6 (FPN) or c4's one level."""
    feats = detector.backbone_features(params, cfg, torch.from_numpy(image)[None].to(device))
    if cfg.use_fpn:
        rpn_feats, lvls = detector.rpn_feature_levels(cfg, feats)
        prefix = "_fpn2"
        strides = [2 ** lvl for lvl in lvls]
        sizes = [(32.0 * 2 ** (lvl - 2),) for lvl in lvls]
    else:
        rpn_feats, prefix = [feats], ""
        strides, sizes = [1.0 / cfg.spatial_scale], [tuple(cfg.anchors.sizes)]
    levels = []
    for f, stride, size in zip(rpn_feats, strides, sizes):
        hidden = rpn_head(params, f, prefix, return_hidden=True)[2][0]
        fh, fw, c = hidden.shape
        levels.append((_numpy(hidden).reshape(fh * fw, c), fh, fw, stride, size))
    return feats, levels


def _device(feats):
    """The device of a pyramid (list of levels) or of a c4 map."""
    return (feats[0] if isinstance(feats, (list, tuple)) else feats).device


def _roi_feats(cfg, feats, rois, size: int):
    """``detector.roi_features`` of one image's (N, 4) numpy rois
    (network-input coords): (N, size, size, C) fp32."""
    rois = torch.as_tensor(np.asarray(rois, np.float32), device=_device(feats))
    return detector.roi_features(cfg, feats, rois[None], size)[0]


def box_feats(cfg, params, feats, rois):
    """Box-head features of (N, 4) network-input rois: (N, 1024) fc7 (FPN)
    or (N, 2048) res5 + mean (C4), numpy."""
    return _numpy(detector.box_head(params, cfg, _roi_feats(cfg, feats, rois, cfg.roi_size)))


def mask_trunk_feats(cfg, params, feats, rois):
    """Activations right before mask_fcn_logits: (K, 256, M, M) numpy."""
    x = _roi_feats(cfg, feats, rois, cfg.mask.roi_size)
    return _nchw(heads_mod.mask_trunk(params, x, cfg.mask.head_type, cfg.arch))


def kp_trunk_feats(cfg, params, feats, rois):
    """Keypoint trunk activations: (K, conv_dim, 14, 14) numpy."""
    x = _roi_feats(cfg, feats, rois, cfg.keypoint.roi_size)
    return _nchw(heads_mod.keypoint_trunk(params, x, cfg.keypoint.num_convs))


def proposals(cfg, params, feats, image, entry, scale):
    """The RPN's proposals on one image (``detector.rpn_proposals`` with the
    engine's clip bounds), valid ones in score order: (P, 4) float64."""
    dev = _device(feats)
    f32 = dict(dtype=torch.float32, device=dev)
    im_scale = torch.tensor([scale], **f32)
    im_h, im_w = detector.blob_bounds(cfg, image.shape[:2], im_scale,
                                      torch.tensor([entry.height], **f32),
                                      torch.tensor([entry.width], **f32))
    props = detector.rpn_proposals(params, cfg, feats, im_h, im_w, im_scale)
    return _numpy(props.boxes[0][props.valid[0]]).astype(np.float64)


def start_params(cfg, seed: int, rng):
    """The fit's frozen weights: ``init_params(cfg, seed)`` (numpy, JAX
    layout) with the frozen-BN affines perturbed from `rng` and the RPN
    regression damped, as the harness starts."""
    params = _perturb_bn(detector.init_params(cfg, seed=seed), rng)
    # Damp the (untrained) RPN regression so proposals stay anchor-shaped:
    # random-init deltas on O(100) features decode to off-image slivers,
    # which would starve the probe detector of usable proposals.
    for k in list(params):
        if k.startswith("rpn_bbox_pred"):
            params[k] = params[k] * 1e-3
    return params


def make_probe_weights(family: str, dataset: CocoDataset, device="cuda",
                       cache_root: str = DEFAULT_ROOT, shapes: str = "harness"):
    """Probe weights for one backbone family, fitted on `dataset` with the
    port's forward on `device` (numpy, JAX layout; see the module
    docstring). `shapes='production'` fits at 800/1333 (cached apart):
    probes fitted at the 256 harness scale are degenerate at production
    scale. Cached as ``torch_weights_<family>_<shapes>.pkl`` under
    `cache_root`."""
    os.makedirs(cache_root, exist_ok=True)
    cache = os.path.join(cache_root, f"torch_weights_{family}_{shapes}.pkl")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            return pickle.load(f)

    device = torch.device(device)
    cfg, tcfg = harness_cfg(FAMILY_PRESET[family], shapes=shapes)
    rng = np.random.RandomState(FAMILY_SEED[family])
    params = start_params(cfg, FAMILY_SEED[family], rng)

    def on_device(p):
        return params_to_device(params_from_jax(p), device)

    roidb = dataset.get_roidb(gt=True)
    with no_tf32():
        # ---- pass 1: backbones + RPN hidden features + anchor labels ----
        cached = []          # (entry, image, scale, backbone features)
        rpn_hid, rpn_lab = [], []
        with torch.inference_mode():
            weights = on_device(params)
            for entry in roidb:
                im = T.load_image_rgb(entry.file_path)
                image, scale, _ = T.preprocess_image(
                    im, tcfg.target_size, tcfg.max_size,
                    pad_stride=cfg.fpn.coarsest_stride if cfg.use_fpn else 32,
                    buckets=None,
                )
                feats, levels = backbone_rpn_levels(cfg, weights, image, device)
                gt = entry.boxes[entry.gt_classes > 0] * scale
                for hidden, fh, fw, stride, sizes in levels:
                    anchors = shifted_anchors(
                        fh, fw, float(stride), tuple(sizes),
                        tuple(cfg.anchors.aspect_ratios),
                    )
                    n_anchor = len(sizes) * len(cfg.anchors.aspect_ratios)
                    lab, _ = _label_by_iou(
                        np.asarray(anchors, np.float64), gt,
                        np.ones(len(gt), np.int64), fg_thresh=0.4,
                    )
                    rpn_hid.append(hidden)
                    rpn_lab.append(lab.reshape(fh * fw, n_anchor))
                cached.append((entry, image, scale, feats))

        prefix = "_fpn2" if cfg.use_fpn else ""
        w_rpn, b_rpn = _train_rpn_probe(
            np.vstack(rpn_hid), np.vstack(rpn_lab).astype(np.float32)
        )
        params[f"rpn_cls_logits{prefix}_w"] = w_rpn
        params[f"rpn_cls_logits{prefix}_b"] = b_rpn

        # ---- pass 2: head probes on the trained-RPN proposal distribution
        feats_all, labels_all, tgt_all = [], [], []
        mask_feats_all, mask_tgt_all, mask_cls_all = [], [], []
        kp_feats_all, kp_bins_all, kp_vis_all = [], [], []
        with torch.inference_mode():
            weights = on_device(params)
            for entry, image, scale, feats in cached:
                props = proposals(cfg, weights, feats, image, entry, scale)[:60]
                rois, labels, gti, gt, gt_cls = _probe_rois(entry, scale, rng)
                p_labels, p_gti = _label_by_iou(props, gt, gt_cls)
                rois = np.vstack([rois, props])
                labels = np.concatenate([labels, p_labels])
                gti = np.concatenate([gti, p_gti])
                feats_all.append(box_feats(cfg, weights, feats, rois))
                labels_all.append(labels)
                # bbox regression targets for positive rois
                pos = labels > 0
                tg = np.zeros((len(rois), 4), np.float32)
                if pos.any():
                    tg[pos] = _bbox_targets(rois[pos], gt[gti[pos]])
                tgt_all.append(tg)
                # mask probe set: gt boxes only
                if cfg.use_mask and len(gt):
                    mask_feats_all.append(mask_trunk_feats(cfg, weights, feats, gt))
                    for i in range(len(gt)):
                        mask_tgt_all.append(
                            _mask_target(entry, i, gt[i] / scale, cfg.mask.resolution)
                        )
                        mask_cls_all.append(int(gt_cls[i]))
                # keypoint probe set: gt boxes with gt keypoint heatmap bins
                if cfg.keypoint is not None and len(gt):
                    gt_rows = np.where(entry.gt_classes > 0)[0]
                    bins, vis = keypoints_to_heatmap_labels(
                        entry.gt_keypoints[gt_rows], entry.boxes[gt_rows],
                        cfg.keypoint.heatmap_size,
                    )
                    kp_feats_all.append(kp_trunk_feats(cfg, weights, feats, gt))
                    kp_bins_all.append(bins)
                    kp_vis_all.append(vis)
        del cached, weights

    cls_w, cls_b, bbox_w, bbox_b = _train_box_probes(
        np.vstack(feats_all), np.concatenate(labels_all), np.vstack(tgt_all), params, rng
    )
    params["cls_score_w"] = cls_w
    params["cls_score_b"] = cls_b
    params["bbox_pred_w"] = bbox_w
    params["bbox_pred_b"] = bbox_b

    if cfg.use_mask:
        mw, mb = _train_mask_probe(np.vstack(mask_feats_all), np.stack(mask_tgt_all),
                                   np.asarray(mask_cls_all), params)
        params["mask_fcn_logits_w"] = mw
        params["mask_fcn_logits_b"] = mb

    if cfg.keypoint is not None:
        kw, kb = _train_kp_probe(
            np.vstack(kp_feats_all), np.vstack(kp_bins_all),
            np.vstack(kp_vis_all), params,
        )
        params["kps_score_lowres_w"] = kw
        params["kps_score_lowres_b"] = kb

    tmp = f"{cache}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(params, f)
    os.replace(tmp, cache)
    return params

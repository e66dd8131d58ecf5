"""Mask R-CNN inference in plain PyTorch, fp32, on Detectron's caffe2 blobs.

The benchmark's yardstick: it reads the blobs in caffe2's own layouts
(OIHW convs, conv1 on BGR input, fc6 flattened (C, H, W)-major, deconvs
(C_in, C_out, kh, kw)) and computes in NCHW, with no kernel, cache or
batching of the program under test. It follows Detectron's
``e2e_mask_rcnn_R-50-{FPN,C4}_2x`` at test time:

  * ResNet-50, stride on the 1x1 ``branch2a``, frozen BN as an affine;
  * FPN: laterals, nearest top-down, 3x3 outputs, P6 subsampled from P5;
    the shared RPN head on P2..P6, one anchor size a level, per-level top
    ``pre`` -> NMS 0.7 -> ``post``, then the global top ``post``;
    C4: the RPN head on res4, 15 anchors, top ``pre`` -> NMS 0.7 -> ``post``;
  * box branch: RoIAlign 7x7 (sampling 2) per FPN level + fc6/fc7, or
    RoIAlign 14x14 (adaptive grid) + res5 + mean; then softmax and deltas;
  * per-class NMS 0.5 over scores > 0.05, the global cap at ``dets`` (every
    detection >= the k-th score, up to ``dets + slack`` slots);
  * mask branch on the detections: 4 convs + deconv (FPN) or res5 + deconv
    (C4), sigmoid, the detection's class.

A ``Precision`` rounds the operands of every conv and linear layer: none
for the reference, float8 e4m3 with a per-tensor scale for the control
(the lower precision that the bf16 program must stay clear of).
Images are (B, H, W, 3) RGB, mean-subtracted and padded, as the program
takes them; conv1's caffe2 weights read BGR, so the channels are reversed.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import boxes as bx
from benchmark.reference.roi_align import multilevel_roi_align, roi_align_matmul

BLOCKS = (3, 4, 6, 3)  # ResNet-50
STAGES = (("res2", 256), ("res3", 512), ("res4", 1024), ("res5", 2048))
FP8_MAX = 448.0  # float8 e4m3's largest finite value


class Precision:
    """How conv and linear operands are rounded: 'float32' (not at all) or
    'float8' (e4m3, scaled per tensor so that its largest magnitude maps to
    448, the product accumulated in fp32)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(name)
        self.name = name

    def __call__(self, x):
        x = x.float()
        if self.name == "float32":
            return x
        amax = x.abs().amax().clamp_min(1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale


# -- the blobs --------------------------------------------------------------------

def _trunk_spec(spec, stages: int):
    spec["conv1_w"] = (64, 3, 7, 7)
    spec["res_conv1_bn_s"] = spec["res_conv1_bn_b"] = (64,)
    cin = 64
    for si in range(stages):
        name, cout = STAGES[si]
        mid = cout // 4
        for i in range(BLOCKS[si]):
            p = f"{name}_{i}"
            convs = [("branch2a", mid, cin if i == 0 else cout, 1),
                     ("branch2b", mid, mid, 3), ("branch2c", cout, mid, 1)]
            if i == 0:
                convs.insert(0, ("branch1", cout, cin, 1))
            for br, o, c, k in convs:
                spec[f"{p}_{br}_w"] = (o, c, k, k)
                spec[f"{p}_{br}_bn_s"] = spec[f"{p}_{br}_bn_b"] = (o,)
        cin = cout


def last_block(stage: int) -> str:
    return f"{STAGES[stage][0]}_{BLOCKS[stage] - 1}"


def blob_spec(cfg: dict) -> Dict[str, tuple]:
    """Every blob of the configuration, name -> caffe2 shape, in Detectron's
    order (trunk, FPN, RPN, box head, mask head)."""
    m = cfg["model"]
    fpn = m["fpn"]
    spec: Dict[str, tuple] = {}
    _trunk_spec(spec, 4)  # C4 keeps res5 as its box and mask head
    nc, a = m["num_classes"], len(m["anchor_ratios"]) * (1 if fpn else len(m["anchor_sizes"]))
    if fpn:
        ch = m["fpn_channels"]
        for i, (_, cin) in enumerate(STAGES):
            lat = f"fpn_inner_{last_block(i)}_sum" + ("" if i == 3 else "_lateral")
            spec[f"{lat}_w"], spec[f"{lat}_b"] = (ch, cin, 1, 1), (ch,)
            out = f"fpn_{last_block(i)}_sum"
            spec[f"{out}_w"], spec[f"{out}_b"] = (ch, ch, 3, 3), (ch,)
        rin, sfx = ch, "_fpn2"
    else:
        rin, sfx = STAGES[2][1], ""
    spec[f"conv_rpn{sfx}_w"], spec[f"conv_rpn{sfx}_b"] = (rin, rin, 3, 3), (rin,)
    spec[f"rpn_cls_logits{sfx}_w"], spec[f"rpn_cls_logits{sfx}_b"] = (a, rin, 1, 1), (a,)
    spec[f"rpn_bbox_pred{sfx}_w"], spec[f"rpn_bbox_pred{sfx}_b"] = (4 * a, rin, 1, 1), (4 * a,)
    if fpn:
        s = m["box_roi_size"]
        spec["fc6_w"], spec["fc6_b"] = (1024, ch * s * s), (1024,)
        spec["fc7_w"], spec["fc7_b"] = (1024, 1024), (1024,)
        feat = 1024
    else:
        feat = STAGES[3][1]
    spec["cls_score_w"], spec["cls_score_b"] = (nc, feat), (nc,)
    spec["bbox_pred_w"], spec["bbox_pred_b"] = (4 * nc, feat), (4 * nc,)
    if fpn:
        for i in range(1, 5):
            spec[f"_[mask]_fcn{i}_w"], spec[f"_[mask]_fcn{i}_b"] = (ch, ch, 3, 3), (ch,)
        trunk = ch
    else:
        trunk = STAGES[3][1]
    spec["conv5_mask_w"], spec["conv5_mask_b"] = (trunk, 256, 2, 2), (256,)
    spec["mask_fcn_logits_w"], spec["mask_fcn_logits_b"] = (nc, 256, 1, 1), (nc,)
    return spec


# -- layers ---------------------------------------------------------------------

def conv(q: Precision, x, w, b=None, stride: int = 1, pad: int = 0):
    y = F.conv2d(q(x), q(w), stride=stride, padding=pad)
    return y if b is None else y + b.float()[:, None, None]


def linear(q: Precision, x, w, b):
    return q(x) @ q(w).t() + b.float()


def conv_bn(P, q, x, name, stride=1, pad=0):
    y = conv(q, x, P[f"{name}_w"], stride=stride, pad=pad)
    return y * P[f"{name}_bn_s"].float()[:, None, None] + P[f"{name}_bn_b"].float()[:, None, None]


def stage(P, q, x, si: int, stride: int):
    name = STAGES[si][0]
    for i in range(BLOCKS[si]):
        p, s = f"{name}_{i}", stride if i == 0 else 1
        short = conv_bn(P, q, x, f"{p}_branch1", stride=s) if i == 0 else x
        y = F.relu(conv_bn(P, q, x, f"{p}_branch2a", stride=s))
        y = F.relu(conv_bn(P, q, y, f"{p}_branch2b", pad=1))
        x = F.relu(conv_bn(P, q, y, f"{p}_branch2c") + short)
    return x


def body(P, q, images, stages: int):
    """(B, H, W, 3) RGB -> [c2, ..., c_{stages+1}] NCHW fp32."""
    x = images.float().flip(-1).permute(0, 3, 1, 2).contiguous()  # BGR, NCHW
    x = conv(q, x, P["conv1_w"], stride=2, pad=3)
    x = F.relu(x * P["res_conv1_bn_s"].float()[:, None, None]
               + P["res_conv1_bn_b"].float()[:, None, None])
    x = F.max_pool2d(x, 3, 2, 1)
    outs = []
    for si in range(stages):
        x = stage(P, q, x, si, 1 if si == 0 else 2)
        outs.append(x)
    return outs


def fpn_neck(P, q, cs):
    lat = []
    for i, c in enumerate(cs):
        name = f"fpn_inner_{last_block(i)}_sum" + ("" if i == 3 else "_lateral")
        lat.append(conv(q, c, P[f"{name}_w"], P[f"{name}_b"]))
    for i in range(len(lat) - 2, -1, -1):
        lat[i] = lat[i] + F.interpolate(lat[i + 1], scale_factor=2, mode="nearest")
    outs = [conv(q, l, P[f"fpn_{last_block(i)}_sum_w"], P[f"fpn_{last_block(i)}_sum_b"], pad=1)
            for i, l in enumerate(lat)]
    return outs + [outs[-1][:, :, ::2, ::2]]  # P2..P6


def rpn_head(P, q, x, sfx: str):
    """NCHW -> (probs (B, H*W*A), deltas (B, H*W*A, 4)) in the (H, W, A) order."""
    h = F.relu(conv(q, x, P[f"conv_rpn{sfx}_w"], P[f"conv_rpn{sfx}_b"], pad=1))
    logits = conv(q, h, P[f"rpn_cls_logits{sfx}_w"], P[f"rpn_cls_logits{sfx}_b"])
    deltas = conv(q, h, P[f"rpn_bbox_pred{sfx}_w"], P[f"rpn_bbox_pred{sfx}_b"])
    bsz = x.shape[0]
    return (torch.sigmoid(logits).permute(0, 2, 3, 1).reshape(bsz, -1),
            deltas.permute(0, 2, 3, 1).reshape(bsz, -1, 4))


# -- proposals --------------------------------------------------------------------

class Proposals(NamedTuple):
    boxes: torch.Tensor   # (B, post, 4)
    scores: torch.Tensor  # (B, post)
    valid: torch.Tensor   # (B, post)


def bounds(cfg: dict, hw, im_scale, orig_h, orig_w):
    """The proposals' clip bounds: the resized image, ceiled to the coarsest
    FPN stride on FPN, capped at the padded blob."""
    h, w = hw
    im_h = torch.clamp_max(torch.round(orig_h * im_scale), h)
    im_w = torch.clamp_max(torch.round(orig_w * im_scale), w)
    if cfg["model"]["fpn"]:
        s = float(cfg["model"]["coarsest_stride"])
        im_h = torch.clamp_max(torch.ceil(im_h / s) * s, h)
        im_w = torch.clamp_max(torch.ceil(im_w / s) * s, w)
    return im_h, im_w


def level_proposals(probs, deltas, anchors, im_h, im_w, im_scale, pre, post, nms_thresh,
                    min_size):
    """Per level: top ``pre``, decode, clip, filter, NMS to ``post``."""
    out = []
    for sc, de, an in zip(probs, deltas, anchors):
        k = min(pre, sc.shape[1])
        top, idx = bx.topk_stable(sc, k)
        props = bx.bbox_transform(an[idx], torch.gather(de, 1, idx[..., None].expand(-1, -1, 4)))
        props = bx.clip_boxes(props, im_h[:, None], im_w[:, None])
        ok = bx.filter_boxes_mask(props, min_size, im_scale[:, None], im_h[:, None],
                                  im_w[:, None])
        keep, kv = bx.batched_nms(props, top, post, nms_thresh, valid=ok)
        out.append(Proposals(torch.gather(props, 1, keep[..., None].expand(-1, -1, 4)),
                             torch.where(kv, torch.gather(top, 1, keep),
                                         torch.zeros_like(kv, dtype=top.dtype)), kv))
    return out


def collect(level_props: List[Proposals], post: int) -> Proposals:
    boxes = torch.cat([p.boxes for p in level_props], 1)
    scores = torch.cat([p.scores for p in level_props], 1)
    valid = torch.cat([p.valid for p in level_props], 1)
    top, idx = bx.topk_stable(torch.where(valid, scores, torch.full_like(scores, bx.NEG_INF)),
                              post)
    ok = top > bx.NEG_INF
    return Proposals(torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
                     torch.where(ok, top, torch.zeros_like(top)), ok)


def fpn_levels(cfg: dict, rois):
    m = cfg["model"]
    s = torch.sqrt(bx.boxes_area(rois))
    lvl = torch.floor(m["roi_canonical_level"] + torch.log2(s / m["roi_canonical_scale"] + 1e-6))
    return torch.clamp(lvl, m["roi_min_level"], m["roi_max_level"]).long() - m["roi_min_level"]


# -- the model --------------------------------------------------------------------

class Features(NamedTuple):
    maps: list          # FPN: [P2..P6] NCHW; C4: [c4] NCHW
    nhwc: list          # the RoIAlign inputs, NHWC: FPN [P2..P5]; C4 [c4]


def features(cfg: dict, P, q: Precision, images) -> Features:
    if cfg["model"]["fpn"]:
        maps = fpn_neck(P, q, body(P, q, images, 4))
        return Features(maps, [m.permute(0, 2, 3, 1).contiguous() for m in maps[:4]])
    c4 = body(P, q, images, 3)[-1]
    return Features([c4], [c4.permute(0, 2, 3, 1).contiguous()])


def proposals(cfg: dict, P, q: Precision, feats: Features, im_h, im_w, im_scale,
              pre: Optional[int] = None, post: Optional[int] = None) -> Proposals:
    """The RPN's proposals at the test counts; `pre` and `post` over the
    test's keep runners-up too: the boxes that the test's counts keep stay
    first and in order, the others follow."""
    m, t = cfg["model"], cfg["test"]
    pre = pre or t["rpn_pre_nms_top_n"]
    post = post or t["rpn_post_nms_top_n"]
    dev = feats.maps[0].device
    if m["fpn"]:
        probs, deltas, anchors = [], [], []
        for i, f in enumerate(feats.maps):
            lvl = m["roi_min_level"] + i
            pr, de = rpn_head(P, q, f, "_fpn2")
            probs.append(pr)
            deltas.append(de)
            anchors.append(bx.shifted_anchors(f.shape[2], f.shape[3], 2.0 ** lvl,
                                              (m["anchor_sizes"][0] * 2 ** (lvl - 2),),
                                              m["anchor_ratios"], dev))
        lp = level_proposals(probs, deltas, anchors, im_h, im_w, im_scale, pre, post,
                             t["rpn_nms_thresh"], 0.0)
        return collect(lp, post)
    f = feats.maps[0]
    pr, de = rpn_head(P, q, f, "")
    an = bx.shifted_anchors(f.shape[2], f.shape[3], 1.0 / m["spatial_scale"], m["anchor_sizes"],
                            m["anchor_ratios"], dev)
    return level_proposals([pr], [de], [an], im_h, im_w, im_scale, pre, post,
                           t["rpn_nms_thresh"], 0.0)[0]


def roi_feats(cfg: dict, feats: Features, rois, size: int, image: int = 0):
    """RoIAlign of one image's (N, 4) rois -> (N, C, size, size) fp32."""
    m = cfg["model"]
    if m["fpn"]:
        scales = [1.0 / 2 ** l for l in range(m["roi_min_level"], m["roi_max_level"] + 1)]
        bidx = torch.full((rois.shape[0],), image, dtype=torch.long, device=rois.device)
        out = multilevel_roi_align(feats.nhwc, rois, bidx, fpn_levels(cfg, rois), scales, size,
                                   m["roi_sampling_ratio"])
    else:
        out = roi_align_matmul(feats.nhwc[0][image], rois, size, m["spatial_scale"],
                               m["roi_sampling_ratio"])
    return out.permute(0, 3, 1, 2).contiguous()


def box_head(cfg: dict, P, q: Precision, x):
    """(N, C, S, S) roi features -> (class probabilities (N, K), deltas (N, 4K))."""
    if cfg["model"]["fpn"]:
        h = F.relu(linear(q, x.reshape(x.shape[0], -1), P["fc6_w"], P["fc6_b"]))
        h = F.relu(linear(q, h, P["fc7_w"], P["fc7_b"]))
    else:
        h = stage(P, q, x, 3, 2).mean(dim=(2, 3))
    return (torch.softmax(linear(q, h, P["cls_score_w"], P["cls_score_b"]), -1),
            linear(q, h, P["bbox_pred_w"], P["bbox_pred_b"]))


def mask_head(cfg: dict, P, q: Precision, x, classes):
    """(N, C, 14, 14) roi features, (N,) classes -> (N, M, M) probabilities."""
    if cfg["model"]["fpn"]:
        for i in range(1, 5):
            x = F.relu(conv(q, x, P[f"_[mask]_fcn{i}_w"], P[f"_[mask]_fcn{i}_b"], pad=1))
    else:
        x = stage(P, q, x, 3, 2)
    x = F.relu(F.conv_transpose2d(q(x), q(P["conv5_mask_w"]), stride=2)
               + P["conv5_mask_b"].float()[:, None, None])
    logits = conv(q, x, P["mask_fcn_logits_w"], P["mask_fcn_logits_b"])
    return torch.sigmoid(logits[torch.arange(x.shape[0], device=x.device), classes])


def decode(cfg: dict, deltas, rois, im_scale, orig_h, orig_w):
    """Every roi's box for every class, (N, K, 4), in original-image
    coordinates, clipped to the image."""
    pred = bx.bbox_transform(rois / im_scale, deltas, tuple(cfg["test"]["bbox_reg_weights"]))
    return bx.clip_boxes(pred, orig_h, orig_w).reshape(rois.shape[0], -1, 4)


class Detections(NamedTuple):
    boxes: torch.Tensor    # (K, 4) original-image coords
    scores: torch.Tensor   # (K,)
    classes: torch.Tensor  # (K,) int64
    valid: torch.Tensor    # (K,) bool


def postprocess(cfg: dict, probs, deltas, rois, roi_valid, im_scale, orig_h, orig_w,
                dets: Optional[int] = None) -> Detections:
    """One image: decode (weights 10, 10, 5, 5), clip to the original image,
    per-class NMS over scores > thresh, the global cap at `dets` (the test's
    by default) keeping every score >= the k-th, within dets + slack slots."""
    t = cfg["test"]
    k = dets or t["detections_per_img"]
    k_pad = k + t["detections_tie_slack"]
    n, nc = probs.shape[0], probs.shape[1] - 1
    pred = decode(cfg, deltas, rois, im_scale, orig_h, orig_w)
    cls_boxes = pred[:, 1:].permute(1, 0, 2)
    cls_sc = probs[:, 1:].t()
    valid = roi_valid[None, :].expand(nc, n) & (cls_sc > t["score_thresh"])
    keep, ok = bx.batched_nms(cls_boxes, cls_sc, k_pad, t["nms_thresh"], valid=valid)
    sc = torch.where(ok, torch.gather(cls_sc, 1, keep), torch.full_like(keep, bx.NEG_INF,
                                                                          dtype=torch.float32))
    kb = torch.gather(cls_boxes, 1, keep[..., None].expand(-1, -1, 4))
    flat_sc, flat_b = sc.reshape(-1), kb.reshape(-1, 4)
    flat_cls = torch.arange(1, nc + 1, device=probs.device)[:, None].expand(nc, k_pad).reshape(-1)
    top, idx = bx.topk_stable(flat_sc, k_pad)
    n_dets = (flat_sc > bx.NEG_INF).sum()
    ok = torch.where(n_dets > k, top >= top[k - 1], top > bx.NEG_INF)
    return Detections(flat_b[idx], torch.where(ok, top, torch.zeros_like(top)),
                      torch.where(ok, flat_cls[idx], torch.zeros_like(idx)), ok)


class Outputs(NamedTuple):
    """One image's outputs, the fields the program's request returns."""
    rois: torch.Tensor        # (N, 4) scaled coords
    roi_valid: torch.Tensor   # (N,)
    cls_scores: torch.Tensor  # (N, K)
    bbox_deltas: torch.Tensor  # (N, 4K)
    det: Detections
    masks: torch.Tensor       # (D, M, M) on every detection slot


def infer(cfg: dict, P, q: Precision, images, im_scale, orig_h, orig_w) -> List[Outputs]:
    """The whole request, image by image: what the program computes, in
    the precision `q` (the control puts this in the program's place)."""
    out = []
    for i in range(images.shape[0]):
        feats = features(cfg, P, q, images[i:i + 1])
        im_h, im_w = bounds(cfg, images.shape[1:3], im_scale[i:i + 1], orig_h[i:i + 1],
                            orig_w[i:i + 1])
        props = proposals(cfg, P, q, feats, im_h, im_w, im_scale[i:i + 1])
        rois, ok = props.boxes[0], props.valid[0]
        x = roi_feats(cfg, feats, rois, cfg["model"]["box_roi_size"])
        probs, deltas = box_head(cfg, P, q, x)
        det = postprocess(cfg, probs, deltas, rois, ok, im_scale[i], orig_h[i], orig_w[i])
        x = roi_feats(cfg, feats, det.boxes * im_scale[i], cfg["model"]["mask_roi_size"])
        out.append(Outputs(rois, ok, probs, deltas, det, mask_head(cfg, P, q, x, det.classes)))
        del feats
    return out

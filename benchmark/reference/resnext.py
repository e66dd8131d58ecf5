"""ResNeXt FPN Mask R-CNN inference in plain PyTorch, fp32, on Detectron's
caffe2 blobs: the yardstick of ``e2e_mask_rcnn_X-101-64x4d-FPN_1x``.

The trunk is Detectron's ResNeXt (Xie et al., arXiv:1611.05431;
``modeling/ResNet.py``, ``bottleneck_transformation``), read from the
configuration's ``trunk`` group, named after the yaml's ``RESNETS`` keys:
``blocks`` a stage, ``groups`` (``NUM_GROUPS``), ``width_per_group``
(``WIDTH_PER_GROUP``) and ``stride_1x1`` (``STRIDE_1X1``). Each block:

  * ``branch2a``: 1x1 from the block's input to the inner width
    ``groups * width_per_group * 2**s`` at stage s (res2 = 0), frozen BN,
    relu; it carries the block's stride only where ``stride_1x1``;
  * ``branch2b``: 3x3 in ``groups`` groups (``F.conv2d(..., groups=)``),
    caffe2 shape (inner, inner // groups, 3, 3), frozen BN, relu; it
    carries the stride where ``stride_1x1`` is false (the Torch-trained
    ImageNet models Detectron starts from);
  * ``branch2c``: 1x1 to 256 * 2**s, frozen BN; plus ``branch1`` (1x1 with
    the stride, frozen BN) on each stage's first block; relu of the sum.

The stem (conv1 7x7/2, frozen BN, relu, max-pool 3x3/2) and everything
after the trunk are ``reference/model.py``'s, unchanged: the FPN neck, the
RPN and its proposals, the box and mask heads and the postprocess, with
the test settings of Detectron's yaml (scale 800, max size 1333, RPN 1000
-> 1000 a level, NMS 0.5). The FPN's blobs are named after each stage's
last block (``fpn_inner_res4_22_sum_lateral`` on a 23-block res4), which
``model.py`` names after ResNet-50's: the neck is handed a view of the
blobs under ResNet-50's names.

Departures from Detectron: frozen BN is an affine, as Detectron exports
it; the images are the program's mean-subtracted RGB blobs, reversed to
BGR for conv1, as in ``model.py``; the blobs are drawn from the run's seed,
not the trained ``model_final.pkl``. Only FPN bodies are built.
"""

from __future__ import annotations

from typing import Dict, List

import torch.nn.functional as F

from benchmark.reference import model as M
# what harness/check.py reads of its reference, the same as model.py's
from benchmark.reference.model import (  # noqa: F401
    STAGES, Detections, Features, Outputs, Precision, bounds, box_head, conv, conv_bn,
    decode, mask_head, postprocess, proposals, roi_feats)


def inner_width(cfg: dict, si: int) -> int:
    t = cfg["trunk"]
    return t["groups"] * t["width_per_group"] * 2 ** si


def last_block(cfg: dict, si: int) -> str:
    return f"{STAGES[si][0]}_{cfg['trunk']['blocks'][si] - 1}"


def _trunk_spec(cfg: dict) -> Dict[str, tuple]:
    t = cfg["trunk"]
    spec = {"conv1_w": (64, 3, 7, 7), "res_conv1_bn_s": (64,), "res_conv1_bn_b": (64,)}
    cin = 64
    for si, (name, cout) in enumerate(STAGES):
        mid = inner_width(cfg, si)
        for i in range(t["blocks"][si]):
            p = f"{name}_{i}"
            convs = [("branch2a", (mid, cin if i == 0 else cout, 1, 1)),
                     ("branch2b", (mid, mid // t["groups"], 3, 3)),
                     ("branch2c", (cout, mid, 1, 1))]
            if i == 0:
                convs.insert(0, ("branch1", (cout, cin, 1, 1)))
            for br, shape in convs:
                spec[f"{p}_{br}_w"] = shape
                spec[f"{p}_{br}_bn_s"] = spec[f"{p}_{br}_bn_b"] = (shape[0],)
        cin = cout
    return spec


def _neck_names(cfg: dict) -> Dict[str, str]:
    """``model.py``'s FPN blob name -> this trunk's, for each blob whose
    name holds a stage's last block."""
    out = {}
    for name in M.blob_spec(cfg):
        for si in range(4):
            a, b = f"_{M.last_block(si)}_", f"_{last_block(cfg, si)}_"
            if name.startswith("fpn") and a in name:
                out[name] = name.replace(a, b)
    return out


def blob_spec(cfg: dict) -> Dict[str, tuple]:
    """Every blob of the configuration, name -> caffe2 shape, in Detectron's
    order (trunk, FPN, RPN, box head, mask head)."""
    if not cfg["model"]["fpn"]:
        raise ValueError("the ResNeXt reference builds FPN bodies only")
    spec = _trunk_spec(cfg)
    names = _neck_names(cfg)
    for name, shape in M.blob_spec(cfg).items():
        if name != "conv1_w" and not name.startswith("res"):
            spec[names.get(name, name)] = shape
    return spec


def grouped_conv_bn(P, q: Precision, x, name: str, groups: int, stride: int = 1):
    y = F.conv2d(q(x), q(P[f"{name}_w"]), stride=stride, padding=1, groups=groups)
    return (y * P[f"{name}_bn_s"].float()[:, None, None]
            + P[f"{name}_bn_b"].float()[:, None, None])


def stage(cfg: dict, P, q: Precision, x, si: int, stride: int):
    t = cfg["trunk"]
    name = STAGES[si][0]
    for i in range(t["blocks"][si]):
        p, s = f"{name}_{i}", stride if i == 0 else 1
        s1, s3 = (s, 1) if t["stride_1x1"] else (1, s)
        short = conv_bn(P, q, x, f"{p}_branch1", stride=s) if i == 0 else x
        y = F.relu(conv_bn(P, q, x, f"{p}_branch2a", stride=s1))
        y = F.relu(grouped_conv_bn(P, q, y, f"{p}_branch2b", t["groups"], stride=s3))
        x = F.relu(conv_bn(P, q, y, f"{p}_branch2c") + short)
    return x


def body(cfg: dict, P, q: Precision, images):
    """(B, H, W, 3) RGB -> [c2, c3, c4, c5] NCHW fp32."""
    x = images.float().flip(-1).permute(0, 3, 1, 2).contiguous()  # BGR, NCHW
    x = conv(q, x, P["conv1_w"], stride=2, pad=3)
    x = F.relu(x * P["res_conv1_bn_s"].float()[:, None, None]
               + P["res_conv1_bn_b"].float()[:, None, None])
    x = F.max_pool2d(x, 3, 2, 1)
    outs = []
    for si in range(4):
        x = stage(cfg, P, q, x, si, 1 if si == 0 else 2)
        outs.append(x)
    return outs


def features(cfg: dict, P, q: Precision, images) -> Features:
    view = {**P, **{a: P[b] for a, b in _neck_names(cfg).items()}}
    maps = M.fpn_neck(view, q, body(cfg, P, q, images))
    return Features(maps, [m.permute(0, 2, 3, 1).contiguous() for m in maps[:4]])


def infer(cfg: dict, P, q: Precision, images, im_scale, orig_h, orig_w) -> List[Outputs]:
    """The whole request, image by image (``model.infer`` on this trunk)."""
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

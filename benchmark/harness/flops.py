"""The work the cells' requests need, counted by the benchmark, and the
H100's peaks.

``request_layer_flops`` counts the conv and linear layers of one inference
request from the architecture at the cell's shapes (every tap of a conv,
padding included, as the card computes it; an FMA is 2). The RoIAlign
calls are counted from their rois (``roi_align_calls``): the feature pixels
their taps touch, each read once, and their fp32 operations. The work is
fixed by the inputs, whatever implements it.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from benchmark.reference import model as M
from benchmark.reference.roi_align import gather_work, separable_work

# NVIDIA's data sheet, H100 SXM at its 700 W limit: dense bf16 tensor-core
# rate, fp32 CUDA-core rate, HBM3 bandwidth
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def _out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


class Layers:
    """A running sum of conv and linear FLOPs."""

    def __init__(self):
        self.flops = 0

    def conv(self, b, h, w, cin, cout, k, stride=1, pad=0):
        ho, wo = _out(h, k, stride, pad), _out(w, k, stride, pad)
        self.flops += 2 * b * ho * wo * k * k * cin * cout
        return ho, wo

    def deconv(self, b, h, w, cin, cout, k):
        """A stride-k transposed conv of kernel k: every input pixel meets it."""
        self.flops += 2 * b * h * w * cin * cout * k * k
        return k * h, k * w

    def linear(self, rows, cin, cout):
        self.flops += 2 * rows * cin * cout

    def stage(self, b, h, w, cin, si: int, stride: int):
        cout = M.STAGES[si][1]
        mid = cout // 4
        for i in range(M.BLOCKS[si]):
            s = stride if i == 0 else 1
            if i == 0:
                self.conv(b, h, w, cin, cout, 1, s)
            ho, wo = self.conv(b, h, w, cin if i == 0 else cout, mid, 1, s)
            self.conv(b, ho, wo, mid, mid, 3, 1, 1)
            self.conv(b, ho, wo, mid, cout, 1)
            h, w, cin = ho, wo, cout
        return h, w


def request_layer_flops(cfg: dict, batch: int, height: int, width: int) -> int:
    """Conv and linear FLOPs of one request of `batch` blobs of height x
    width: trunk (with res5 on FPN), FPN laterals and outputs, the RPN head
    on every level, the box head on the test's post-NMS rois, the mask head
    on every detection slot (test detections + tie slack)."""
    m, t = cfg["model"], cfg["test"]
    L = Layers()
    h, w = L.conv(batch, height, width, 3, 64, 7, 2, 3)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    maps, cin = [], 64
    for si in range(4 if m["fpn"] else 3):
        h, w = L.stage(batch, h, w, cin, si, 1 if si == 0 else 2)
        cin = M.STAGES[si][1]
        maps.append((h, w, cin))
    if m["fpn"]:
        ch = m["fpn_channels"]
        for h, w, c in maps:
            L.conv(batch, h, w, c, ch, 1)
            L.conv(batch, h, w, ch, ch, 3, 1, 1)
        levels = [mp[:2] for mp in maps] + [((maps[-1][0] + 1) // 2, (maps[-1][1] + 1) // 2)]
        rpn_in, a = ch, len(m["anchor_ratios"])
    else:
        levels, rpn_in = [maps[-1][:2]], maps[-1][2]
        a = len(m["anchor_ratios"]) * len(m["anchor_sizes"])
    for h, w in levels:
        L.conv(batch, h, w, rpn_in, rpn_in, 3, 1, 1)
        L.conv(batch, h, w, rpn_in, a, 1)
        L.conv(batch, h, w, rpn_in, 4 * a, 1)
    rows, s = batch * t["rpn_post_nms_top_n"], m["box_roi_size"]
    if m["fpn"]:
        L.linear(rows, s * s * ch, 1024)
        L.linear(rows, 1024, 1024)
        feat = 1024
    else:
        L.stage(rows, s, s, maps[-1][2], 3, 2)
        feat = M.STAGES[3][1]
    L.linear(rows, feat, m["num_classes"])
    L.linear(rows, feat, 4 * m["num_classes"])
    dets, s = batch * (t["detections_per_img"] + t["detections_tie_slack"]), m["mask_roi_size"]
    if m["fpn"]:
        for _ in range(4):
            L.conv(dets, s, s, ch, ch, 3, 1, 1)
        hw, trunk = s, ch
    else:
        hw, _ = L.stage(dets, s, s, maps[-1][2], 3, 2)
        trunk = M.STAGES[3][1]
    mh, mw = L.deconv(dets, hw, hw, trunk, 256, 2)
    L.conv(dets, mh, mw, 256, m["num_classes"], 1)
    return L.flops


def roofline_ms(nbytes: float, flops: float) -> float:
    """The least time of a call: its bytes at HBM rate or its fp32
    operations at the CUDA cores' rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3


def roi_align_calls(cfg: dict, blob_hw, rois_per_call: List[torch.Tensor],
                    feature_bytes: int = 2) -> List[Tuple[float, float]]:
    """(least ms, fp32 operations) of each forward RoIAlign call of a
    request. rois_per_call: per call (B, N, 4) scaled rois (the box call's
    proposals, the mask call's detection slots); the features are the
    pyramid P2..P5 (FPN) or the c4 map (C4) in the compute dtype, the
    output fp32; each roi also reads 24 bytes (box, image, level)."""
    m = cfg["model"]
    bh, bw = blob_hw
    out = []
    for rois, size in zip(rois_per_call, (m["box_roi_size"], m["mask_roi_size"])):
        b, n = rois.shape[:2]
        flat = rois.reshape(-1, 4).float()
        if m["fpn"]:
            ch = m["fpn_channels"]
            lv = range(m["roi_min_level"], m["roi_max_level"] + 1)
            shapes = [(b, bh // 2 ** l, bw // 2 ** l, ch) for l in lv]
            bidx = torch.arange(b, device=rois.device).repeat_interleave(n)
            pixels, ops = gather_work(shapes, flat, bidx, M.fpn_levels(cfg, flat),
                                      [1.0 / 2 ** l for l in lv], size, ch,
                                      m["roi_sampling_ratio"])
        else:
            ch, fh, fw = M.STAGES[2][1], bh // 16, bw // 16
            pixels, ops = 0, 0.0
            for i in range(b):
                p, o = separable_work(rois[i].float(), m["spatial_scale"], size, ch, fh, fw,
                                      m["roi_sampling_ratio"])
                pixels, ops = pixels + p, ops + o
        nbytes = pixels * ch * feature_bytes + 24 * b * n + b * n * size * size * ch * 4
        out.append((roofline_ms(nbytes, ops), float(ops)))
    return out

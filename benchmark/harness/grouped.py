"""The grouped 3x3 convs of a ResNeXt trunk (``reference/resnext.py``),
counted by the benchmark from the configuration's ``trunk`` group.

A grouped conv of ``groups`` groups does ``2 * N * Ho * Wo * k * k *
(C_in / groups) * C_out`` FLOPs (an FMA is 2): each output channel meets
only its group's inputs. Its least bytes are the bf16 input map read
once, the weights in bf16 ((C_out, C_in / groups, k, k)), and the bf16
output written once. Its least time on the H100 is the larger of its
FLOPs at the dense bf16 rate and its bytes at HBM rate
(``harness/flops``' peaks).
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.harness import flops
from benchmark.harness.flops import BF16_FLOPS_PER_S, HBM_BYTES_PER_S, _out

BF16_BYTES = 2

# (batch, height, width, C_in, C_out, kernel, stride, pad, groups)
Call = Tuple[int, int, int, int, int, int, int, int, int]


def conv_flops(b, h, w, cin, cout, k, stride, pad, groups) -> int:
    return 2 * b * _out(h, k, stride, pad) * _out(w, k, stride, pad) * k * k \
        * (cin // groups) * cout


def conv_bytes(b, h, w, cin, cout, k, stride, pad, groups) -> int:
    ho, wo = _out(h, k, stride, pad), _out(w, k, stride, pad)
    return BF16_BYTES * (b * h * w * cin + cout * (cin // groups) * k * k + b * ho * wo * cout)


def least_ms(call: Call) -> float:
    return max(conv_flops(*call) / BF16_FLOPS_PER_S, conv_bytes(*call) / HBM_BYTES_PER_S) * 1e3


class GroupedLayers(flops.Layers):
    """``flops.Layers`` whose stages are ResNeXt's: the inner width
    ``groups * width_per_group * 2**s``, the 3x3 grouped and carrying the
    stride unless ``stride_1x1``. Each grouped conv is kept in ``grouped``."""

    def __init__(self, trunk: dict):
        super().__init__()
        self.trunk = trunk
        self.grouped: List[Call] = []

    def grouped_conv(self, b, h, w, cin, cout, k, stride, pad, groups):
        self.grouped.append((b, h, w, cin, cout, k, stride, pad, groups))
        self.flops += conv_flops(b, h, w, cin, cout, k, stride, pad, groups)
        return _out(h, k, stride, pad), _out(w, k, stride, pad)

    def stage(self, b, h, w, cin, si: int, stride: int):
        t = self.trunk
        cout, mid = flops.M.STAGES[si][1], t["groups"] * t["width_per_group"] * 2 ** si
        for i in range(t["blocks"][si]):
            s = stride if i == 0 else 1
            s1, s3 = (s, 1) if t["stride_1x1"] else (1, s)
            if i == 0:
                self.conv(b, h, w, cin, cout, 1, s)
            h1, w1 = self.conv(b, h, w, cin if i == 0 else cout, mid, 1, s1)
            h, w = self.grouped_conv(b, h1, w1, mid, mid, 3, s3, 1, t["groups"])
            self.conv(b, h, w, mid, cout, 1)
            cin = cout
        return h, w


def trunk_calls(cfg: dict, batch: int, height: int, width: int) -> List[Call]:
    """Every grouped conv of the trunk (conv1..res5) on `batch` blobs of
    height x width."""
    L = GroupedLayers(cfg["trunk"])
    h, w = L.conv(batch, height, width, 3, 64, 7, 2, 3)
    h, w, cin = _out(h, 3, 2, 1), _out(w, 3, 2, 1), 64
    for si in range(4):
        h, w = L.stage(batch, h, w, cin, si, 1 if si == 0 else 2)
        cin = flops.M.STAGES[si][1]
    return L.grouped

"""The benchmark's own count of a request's conv and linear work."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run
from benchmark.harness.flops import request_layer_flops
from benchmark.harness.weights import make_blobs
from benchmark.reference import model as M
from benchmark.tests.small import CELLS, SEED

LAYER_OPS = ("aten.convolution", "aten.mm", "aten.addmm")


def test_flagship_closed_form():
    """552.18 GFLOP an image at 832x1344: the closed form PERF.md gives."""
    _, _, _, cfg, _ = run.load_cell("fpn_mask.infer_b8")
    assert round(request_layer_flops(cfg, 8, 832, 1344) / 8e9, 2) == 552.18


@pytest.mark.parametrize("cell", CELLS)
def test_count_equals_the_reference_layers(cell):
    """The closed form equals FlopCounterMode's count of the reference's
    layers, run at a small size with fixed roi and detection counts."""
    _, _, _, cfg, _ = run.load_cell(cell)
    rois, dets, h, w = 24, 10, 128, 192
    cfg["test"].update(rpn_post_nms_top_n=rois, detections_per_img=dets - 8)
    P = make_blobs(cfg, SEED, "cpu")
    q = M.Precision()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        feats = M.features(cfg, P, q, torch.zeros(1, h, w, 3))
        sfx = "_fpn2" if cfg["model"]["fpn"] else ""
        for f in feats.maps:
            M.rpn_head(P, q, f, sfx)
        s, ms = cfg["model"]["box_roi_size"], cfg["model"]["mask_roi_size"]
        c = feats.nhwc[0].shape[-1]
        M.box_head(cfg, P, q, torch.zeros(rois, c, s, s))
        M.mask_head(cfg, P, q, torch.zeros(dets, c, ms, ms), torch.ones(dets, dtype=torch.long))
    counted = sum(n for op, n in fc.get_flop_counts()["Global"].items() if str(op) in LAYER_OPS)
    assert counted == request_layer_flops(cfg, 1, h, w)

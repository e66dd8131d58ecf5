"""The inference cells of a ResNeXt trunk (``reference/resnext.py``).

``harness/infer.run`` as it is, with the blobs' spec
(``weights.blob_spec``), the check's reference (``check.M``) and the FLOP
count (``flops.Layers``) pointed at the ResNeXt trunk for the length of
the run and restored after, also where it raises. With ``--trace 1`` the
layer context gains ``grouped_conv``: the least ms a request of the
trunk's grouped convs (``harness/grouped.py``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional

from benchmark.harness import check, flops, grouped, infer, weights
from benchmark.reference import resnext


@contextlib.contextmanager
def pointed_at_resnext(cfg: dict):
    saved = check.M, weights.blob_spec, flops.Layers
    check.M, weights.blob_spec = resnext, resnext.blob_spec
    flops.Layers = functools.partial(grouped.GroupedLayers, cfg["trunk"])
    try:
        yield
    finally:
        check.M, weights.blob_spec, flops.Layers = saved


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: Optional[Callable] = None) -> Dict:
    with pointed_at_resnext(cfg):
        r = infer.run(cell, cfg, mix, seed, seconds, trace, device, t_start, fault=fault)
    if r["layer"] is not None:
        calls = grouped.trunk_calls(cfg, mix["batch"], *mix["bucket"])
        r["layer"]["grouped_conv"] = {"bound_ms": sum(map(grouped.least_ms, calls))}
    return r

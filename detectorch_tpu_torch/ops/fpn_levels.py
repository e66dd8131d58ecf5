"""FPN RoI-to-level assignment (FPN paper Eqn. 1).

Port of ``detectorch_tpu/ops/fpn_levels.py``: a per-roi integer level that
feeds the multi-level RoIAlign directly, with no per-level splitting.
"""

from __future__ import annotations

import torch

from detectorch_tpu_torch.ops.boxes import boxes_area


def map_rois_to_fpn_levels(
    rois,
    k_min: int = 2,
    k_max: int = 5,
    canonical_scale: float = 224.0,
    canonical_level: int = 4,
):
    """Target FPN level per roi, clipped to [k_min, k_max]; int32 (...,).

    lvl = floor(lvl0 + log2(sqrt(area)/s0 + 1e-6))
    """
    s = torch.sqrt(boxes_area(rois))
    target = torch.floor(canonical_level + torch.log2(s / canonical_scale + 1e-6))
    return torch.clamp(target, k_min, k_max).to(torch.int32)

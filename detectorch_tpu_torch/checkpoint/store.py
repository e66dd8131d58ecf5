"""Training checkpoints: save, find the latest, restore.

Port of ``detectorch_tpu/checkpoint/store.py`` with its ``ckpt-<step>``
naming under one directory. The JAX package writes orbax pytrees; the port
writes one ``torch.save`` file per checkpoint holding {"step", "params",
"optimizer"} (parameter tensors and the SGD optimizer's ``state_dict``, whose
momentum buffers make a resumed run continue exactly).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

import torch


def save_checkpoint(directory: str, step: int, state: Dict[str, Any]) -> str:
    """Write `state` to ``directory/ckpt-<step>`` (atomically) and return
    the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"ckpt-{step}"))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix="tmp-ckpt-")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(state, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the ``ckpt-<step>`` with the highest step, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("ckpt-"):
            try:
                steps.append(int(name.split("-", 1)[1]))
            except ValueError:
                pass
    if not steps:
        return None
    return os.path.join(directory, f"ckpt-{max(steps)}")


def restore_checkpoint(path: str, map_location=None) -> Dict[str, Any]:
    """Load a checkpoint written by ``save_checkpoint``."""
    return torch.load(path, map_location=map_location, weights_only=True)

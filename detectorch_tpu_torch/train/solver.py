"""LR schedule, frozen parameters and the SGD update.

Port of ``detectorch_tpu/train/solver.py``: step decay with linear warmup
(reference ``lib/utils/solver.py``), and the update of
``train_fast.py:96-103,157-166`` — grad clip 35 over the trainable
gradients, weight decay, SGD momentum 0.9. The JAX package builds it as the
optax chain set_to_zero(frozen) -> clip_by_global_norm -> add_decayed_weights
-> trace -> scale_by_learning_rate; here frozen leaves carry no gradient and
stay out of the optimizer, and ``torch.optim.SGD`` with ``weight_decay``
and ``momentum`` is the same recursion (buf = momentum * buf + g + wd * p,
first buf = g + wd * p; p -= lr * buf).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from detectorch_tpu_torch.config import SolverConfig
from detectorch_tpu_torch.parallel import mesh as par


def get_lr_at_iter(it: int, cfg: SolverConfig = SolverConfig()) -> float:
    """LR of iteration `it`, computed in float32 as the JAX package does."""
    f32 = np.float32
    it = f32(it)
    steps = np.asarray(list(cfg.steps) + [cfg.max_iter], np.float32)
    ind = f32(np.sum(it >= steps) - 1)
    lr = f32(cfg.base_lr) * f32(cfg.gamma) ** ind
    if it < cfg.warmup_iters:
        alpha = it / f32(cfg.warmup_iters)
        lr = lr * (f32(cfg.warmup_factor) * (f32(1.0) - alpha) + alpha)
    return float(lr)


def frozen_mask(params: Dict, freeze_prefixes: Sequence[str] = ("conv1", "res_conv1", "res2")
                ) -> Dict[str, bool]:
    """True for TRAINABLE params: the stem and res2 are frozen (reference
    train_fast.py:87-90), and so is every frozen-BN scale and bias."""
    def trainable(name: str) -> bool:
        if name.endswith("_bn_s") or name.endswith("_bn_b"):
            return False
        return not name.startswith(tuple(freeze_prefixes))

    return {k: trainable(k) for k in params}


def make_optimizer(cfg: SolverConfig, params: Dict[str, torch.Tensor],
                   trainable_mask: Dict[str, bool]) -> torch.optim.SGD:
    """SGD over the trainable leaves, in the params' order."""
    trainable = [p for k, p in params.items() if trainable_mask[k]]
    return torch.optim.SGD(trainable, lr=get_lr_at_iter(0, cfg), momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay)


def clip_global_norm_(params: Sequence[torch.Tensor], max_norm: float, mesh=None,
                      sharded: Sequence[torch.Tensor] = ()) -> None:
    """``clip_grad_norm_`` over the gradients of `params`, of which
    `sharded` hold a model rank's rows: their squares are summed over
    'model', and every other leaf (the same on each model rank) is counted
    once. Without sharded leaves this is ``clip_grad_norm_`` itself."""
    ids = {id(p) for p in sharded}
    norm = torch.nn.utils.get_total_norm([p.grad for p in params if id(p) not in ids])
    if sharded:
        rows = torch.nn.utils.get_total_norm([p.grad for p in sharded]).square()
        par.all_reduce_sum([rows], mesh, "model")
        norm = torch.sqrt(rows + norm.square())
    torch.nn.utils.clip_grads_with_norm_(params, max_norm, norm)


def apply_update(optimizer: torch.optim.SGD, step: int, cfg: SolverConfig, mesh=None,
                 sharded: Sequence[torch.Tensor] = ()) -> None:
    """One update from the gradients in ``.grad``: clip their global norm
    to cfg.clip_grad_norm, set the LR of iteration `step`, step, and clear
    the gradients. A trainable leaf that the loss did not reach (the RPN
    head in a Fast R-CNN step) gets a zero gradient, so weight decay and
    momentum still move it, as in the optax chain; SGD would skip it. On a
    mesh, `sharded` are the leaves that hold this rank's model rows, and
    the norm is the global one (``clip_global_norm_``)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_global_norm_(params, cfg.clip_grad_norm, mesh, sharded)
    lr = get_lr_at_iter(step, cfg)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)

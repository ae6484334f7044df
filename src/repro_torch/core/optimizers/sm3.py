"""SM3 baseline (Anil et al. 2019) as compared in the paper (port of
``repro/core/optimizers/sm3.py``): one accumulator vector per tensor dim and
the β1>0 momentum variant. The rule is ``transform.scale_by_sm3``; this
module is the paper-named chain."""

from __future__ import annotations

from repro_torch.core.optimizers.base import Optimizer
from repro_torch.core.optimizers.transform import (
    Schedule,
    add_decayed_weights,
    as_optimizer,
    chain,
    scale_by_learning_rate,
    scale_by_sm3,
)

__all__ = ["sm3"]


def sm3(lr: Schedule, b1: float = 0.9, eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    tx = chain(scale_by_sm3(b1=b1, eps=eps), add_decayed_weights(weight_decay),
               scale_by_learning_rate(lr))
    return as_optimizer(tx, name="sm3")

"""Adafactor baseline (Shazeer & Stern 2018) as compared in the paper (port
of ``repro/core/optimizers/adafactor.py``): factored second moment over the
trailing two dims for ndim>=2, a full fp32 one for 1-d, RMS update clipping
d=1.0, AdamW's hyperparameters; ``b1=0`` drops the first moment (the
paper's most memory-efficient setting). The rule is
``transform.scale_by_factored_rms``."""

from __future__ import annotations

from repro_torch.core.optimizers.base import Optimizer
from repro_torch.core.optimizers.transform import (
    Schedule,
    add_decayed_weights,
    as_optimizer,
    chain,
    scale_by_factored_rms,
    scale_by_learning_rate,
)

__all__ = ["adafactor"]


def adafactor(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.01) -> Optimizer:
    tx = chain(
        scale_by_factored_rms(b1=b1, b2=b2, eps=eps, clip_threshold=clip_threshold),
        add_decayed_weights(weight_decay),
        scale_by_learning_rate(lr),
    )
    return as_optimizer(tx, name=f"adafactor(b1={b1})")

"""SGDM and compressed SGDM (paper Alg. 2) as transformation chains (port
of ``repro/core/optimizers/sgdm.py``).

Alg. 2 uses the accumulator convention ``m_t = beta*m_{t-1} + g_t`` (no
``(1-beta)`` damping). Built as ``chain(compressed(trace(beta), {"trace":
policy}), add_decayed_weights, scale_by_learning_rate)``; the momentum state
field is named ``trace``.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.optimizers.base import Optimizer, QuantPolicy
from repro_torch.core.optimizers.transform import (
    Schedule,
    add_decayed_weights,
    as_optimizer,
    chain,
    compressed,
    scale_by_learning_rate,
    trace,
)
from repro_torch.core.quantizer import QuantConfig

__all__ = ["sgdm", "sgdm4bit"]


def sgdm(lr: Schedule, beta: float = 0.9, weight_decay: float = 0.0,
         m_policy: Optional[QuantPolicy] = None, name: str = "sgdm") -> Optimizer:
    tx = chain(
        compressed(trace(beta), {"trace": m_policy or QuantPolicy()}),
        add_decayed_weights(weight_decay),
        scale_by_learning_rate(lr),
    )
    return as_optimizer(tx, name=name)


def sgdm4bit(lr: Schedule, beta: float = 0.9, stochastic_rounding: bool = True,
             **kw) -> Optimizer:
    """Compressed SGDM (Alg. 2) with 4-bit B128/DE momentum. Stochastic
    rounding by default: Theorem 1 assumes an unbiased quantizer."""
    cfg = QuantConfig(bits=4, normalization="blockwise", block_size=128, mapping="de",
                      signed=True, stochastic_rounding=stochastic_rounding)
    return sgdm(lr, beta=beta, m_policy=QuantPolicy(config=cfg), name="sgdm4bit", **kw)

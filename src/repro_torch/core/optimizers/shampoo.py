"""Shampoo family as transformation chains (port of
``repro/core/optimizers/shampoo.py``, *4-bit Shampoo*):

* ``shampoo32`` — blocked Kronecker preconditioners (``scale_by_shampoo``)
  with AdamW grafting, nothing compressed: the parity oracle;
* ``shampoo4bit`` — the same chain with the four Kronecker factor trees
  held as 4-bit B128 ``QuantizedTensor``s under the signed ``dynamic`` map
  (factors carry signs both ways) and the grafting moments on the paper's
  4-bit AdamW recipe.

No kernel route is attached: the fused kernel computes a whole AdamW step
and would drop the preconditioning. The grafting moments keep the
kernel-eligible layout (B128 m, rank-1 v).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.optimizers.adamw import M_4BIT, V_4BIT
from repro_torch.core.optimizers.base import Optimizer, QuantPolicy
from repro_torch.core.optimizers.transform import (
    Schedule,
    add_decayed_weights,
    as_optimizer,
    chain,
    compressed,
    scale_by_learning_rate,
    scale_by_shampoo,
)
from repro_torch.core.quantizer import QuantConfig

__all__ = ["FACTOR_4BIT", "shampoo_chain", "shampoo32", "shampoo4bit"]

# Kronecker-factor quantizer: blockwise absmax over the stacked (nblocks,
# B, B) factor, symmetric signed `dynamic` map (DE has no -1.0).
FACTOR_4BIT = QuantConfig(bits=4, normalization="blockwise", block_size=128, mapping="dynamic",
                          signed=True)


def shampoo_chain(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  weight_decay: float = 0.01, block_size: int = 128, precond_every: int = 10,
                  matrix_eps: float = 1e-6, floor_rel: float = 0.01,
                  m_policy: Optional[QuantPolicy] = None, v_policy: Optional[QuantPolicy] = None,
                  factor_policy: Optional[QuantPolicy] = None):
    """The bare Shampoo chain. ``factor_policy`` governs all four factor
    trees and is forced to ``min_ndim=2``: vector params hold empty
    placeholders that must stay raw."""
    factor_policy = factor_policy or QuantPolicy()
    factor_policy = dataclasses.replace(factor_policy, min_ndim=max(2, factor_policy.min_ndim))
    return chain(
        compressed(
            scale_by_shampoo(b1=b1, b2=b2, eps=eps, block_size=block_size,
                             precond_every=precond_every, matrix_eps=matrix_eps,
                             floor_rel=floor_rel),
            {"m": m_policy or QuantPolicy(), "v": v_policy or QuantPolicy(),
             "stats_l": factor_policy, "stats_r": factor_policy,
             "precond_l": factor_policy, "precond_r": factor_policy},
        ),
        add_decayed_weights(weight_decay),
        scale_by_learning_rate(lr),
    )


def shampoo32(lr: Schedule, name: str = "shampoo32", **kw) -> Optimizer:
    """fp32 blocked Shampoo with AdamW grafting — the parity oracle."""
    return as_optimizer(shampoo_chain(lr, **kw), name=name)


def shampoo4bit(lr: Schedule, stochastic_rounding: bool = False, **kw) -> Optimizer:
    """4-bit Shampoo: 4-bit Kronecker factors + the paper's 4-bit moments."""
    m_cfg, v_cfg, f_cfg = M_4BIT, V_4BIT, FACTOR_4BIT
    if stochastic_rounding:
        m_cfg = dataclasses.replace(m_cfg, stochastic_rounding=True)
        v_cfg = dataclasses.replace(v_cfg, stochastic_rounding=True)
        f_cfg = dataclasses.replace(f_cfg, stochastic_rounding=True)
    return as_optimizer(
        shampoo_chain(lr, m_policy=QuantPolicy(config=m_cfg), v_policy=QuantPolicy(config=v_cfg),
                      factor_policy=QuantPolicy(config=f_cfg), **kw),
        name="shampoo4bit",
    )

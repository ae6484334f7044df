"""AdamW family as transformation chains (port of
``repro/core/optimizers/adamw.py``: ``adamw32``, ``adamw8bit``,
``adamw4bit`` and ``factor4bit``).

Each is ``chain(compressed(scale_by_adam(...), policies),
add_decayed_weights(wd), scale_by_learning_rate(lr))``; ``use_kernel``
attaches a ``FusedAdamWRoute`` so eligible leaves run the fused CUDA kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.optimizers.base import Optimizer, QuantPolicy
from repro_torch.core.optimizers.transform import (
    FusedAdamWRoute,
    Schedule,
    add_decayed_weights,
    as_optimizer,
    chain,
    compressed,
    scale_by_adam,
    scale_by_learning_rate,
)
from repro_torch.core.quantizer import QuantConfig

__all__ = ["adamw_chain", "quantized_adamw", "adamw32", "adamw8bit", "adamw4bit", "factor4bit",
           "M_4BIT", "V_4BIT", "M_8BIT", "V_8BIT"]

# Paper-named quantizer presets (Sec. 5).
M_4BIT = QuantConfig(bits=4, normalization="blockwise", block_size=128, mapping="de", signed=True)
V_4BIT = QuantConfig(bits=4, normalization="rank1", mapping="linear", signed=False)
M_8BIT = QuantConfig(bits=8, normalization="blockwise", block_size=2048, mapping="de", signed=True)
V_8BIT = QuantConfig(bits=8, normalization="blockwise", block_size=2048, mapping="de", signed=False)


def adamw_chain(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.01, m_policy: Optional[QuantPolicy] = None,
                v_policy: Optional[QuantPolicy] = None, use_kernel: bool = False):
    """The bare AdamW chain, the building block of ``partition()`` presets."""
    kernel = (
        FusedAdamWRoute(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
        if use_kernel else None
    )
    return chain(
        compressed(
            scale_by_adam(b1=b1, b2=b2, eps=eps),
            {"m": m_policy or QuantPolicy(), "v": v_policy or QuantPolicy()},
            kernel=kernel,
        ),
        add_decayed_weights(weight_decay),
        scale_by_learning_rate(lr),
    )


def quantized_adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                    weight_decay: float = 0.01, m_policy: Optional[QuantPolicy] = None,
                    v_policy: Optional[QuantPolicy] = None, use_kernel: bool = False,
                    name: str = "adamw") -> Optimizer:
    """AdamW whose moments are stored per ``QuantPolicy`` (None => fp32)."""
    tx = adamw_chain(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                     m_policy=m_policy, v_policy=v_policy, use_kernel=use_kernel)
    return as_optimizer(tx, name=name)


def adamw32(lr: Schedule, **kw) -> Optimizer:
    return quantized_adamw(lr, name="adamw32", **kw)


def adamw8bit(lr: Schedule, exclude_embeddings: bool = True, **kw) -> Optimizer:
    """8-bit AdamW baseline [Dettmers et al. 2022]: B2048/DE, embeddings fp32."""
    exclude = ("embed",) if exclude_embeddings else ()
    return quantized_adamw(lr, m_policy=QuantPolicy(config=M_8BIT, exclude=exclude),
                           v_policy=QuantPolicy(config=V_8BIT, exclude=exclude),
                           name="adamw8bit", **kw)


def adamw4bit(lr: Schedule, stochastic_rounding: bool = False, use_kernel: bool = False,
              **kw) -> Optimizer:
    """The paper's 4-bit AdamW: m B128/DE, v Rank-1/Linear (zero excluded)."""
    m_cfg, v_cfg = M_4BIT, V_4BIT
    if stochastic_rounding:
        m_cfg = dataclasses.replace(m_cfg, stochastic_rounding=True)
        v_cfg = dataclasses.replace(v_cfg, stochastic_rounding=True)
    return quantized_adamw(lr, m_policy=QuantPolicy(config=m_cfg),
                           v_policy=QuantPolicy(config=v_cfg), use_kernel=use_kernel,
                           name="adamw4bit", **kw)


def factor4bit(lr: Schedule, **kw) -> Optimizer:
    """The paper's 4-bit Factor: m B128/DE; v factored (>=2-d) else 4-bit."""
    return quantized_adamw(lr, m_policy=QuantPolicy(config=M_4BIT),
                           v_policy=QuantPolicy(config=V_4BIT, factor_2d=True),
                           name="factor4bit", **kw)

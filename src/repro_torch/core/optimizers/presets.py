"""The production preset built on ``partition()`` (port of
``repro/core/optimizers/presets.py``):

    fp32 partition : embed / head / norm scales / biases  -> uncompressed AdamW
    4-bit partition: everything else                      -> adamw4bit (+SR)

Stochastic rounding is on by default; pass an SR key to the train state to
activate it. ``use_kernel`` (default on) sends eligible body leaves through
the fused CUDA kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.optimizers.adamw import M_4BIT, V_4BIT, adamw_chain
from repro_torch.core.optimizers.base import Optimizer, QuantPolicy
from repro_torch.core.optimizers.transform import Schedule, as_optimizer, label_by_regex, partition

__all__ = ["PRODUCTION_FP32_PATTERNS", "production_labels", "production4bit"]

PRODUCTION_FP32_PATTERNS: Tuple[str, ...] = (
    r"embed",
    r"head",
    r"norm",
    r"(^|/)scale($|/)",
    r"(^|/)bias($|/)",
    r"(^|/)ln_",
)


def production_labels(fp32_patterns: Tuple[str, ...] = PRODUCTION_FP32_PATTERNS):
    """Label fn for ``partition()``: 'fp32' for sensitive leaves, '4bit' else."""
    return label_by_regex(fp32_patterns, "fp32", "4bit")


def production4bit(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   weight_decay: float = 0.01, stochastic_rounding: bool = True,
                   use_kernel: bool = True, fp32_patterns: Optional[Tuple[str, ...]] = None,
                   name: str = "production4bit") -> Optimizer:
    """fp32 embeddings/head/norms/biases, 4-bit (B128/DE m, Rank-1/Linear v)
    body with stochastic rounding."""
    m_cfg, v_cfg = M_4BIT, V_4BIT
    if stochastic_rounding:
        m_cfg = dataclasses.replace(m_cfg, stochastic_rounding=True)
        v_cfg = dataclasses.replace(v_cfg, stochastic_rounding=True)
    common = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    tx = partition(
        {
            "fp32": adamw_chain(lr, **common),
            "4bit": adamw_chain(lr, m_policy=QuantPolicy(config=m_cfg),
                                v_policy=QuantPolicy(config=v_cfg), use_kernel=use_kernel,
                                **common),
        },
        production_labels(tuple(fp32_patterns or PRODUCTION_FP32_PATTERNS)),
    )
    return as_optimizer(tx, name=name)

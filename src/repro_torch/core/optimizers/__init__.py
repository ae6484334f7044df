"""Optimizers of the port (port of ``repro.core.optimizers``): the paper's
4-bit optimizers and every compared baseline, the reference's eleven names,
behind the validated ``make_optimizer(name, lr, **overrides)`` factory."""

from __future__ import annotations

import difflib
import inspect
from typing import Callable, Dict, NamedTuple, Optional, Tuple

from repro_torch.core.optimizers.adafactor import adafactor
from repro_torch.core.optimizers.adamw import (
    M_4BIT,
    M_8BIT,
    V_4BIT,
    V_8BIT,
    adamw32,
    adamw4bit,
    adamw8bit,
    adamw_chain,
    factor4bit,
    quantized_adamw,
)
from repro_torch.core.optimizers.base import (
    FactoredMoment,
    Optimizer,
    QuantPolicy,
    state_nbytes,
    tree_order,
)
from repro_torch.core.optimizers.presets import production4bit
from repro_torch.core.optimizers.schedule import (
    constant,
    linear_warmup_cosine,
    linear_warmup_linear_decay,
)
from repro_torch.core.optimizers.sgdm import sgdm, sgdm4bit
from repro_torch.core.optimizers.shampoo import FACTOR_4BIT, shampoo32, shampoo4bit, shampoo_chain
from repro_torch.core.optimizers.sm3 import sm3
from repro_torch.core.optimizers.transform import (
    scale_by_factored_rms,
    scale_by_shampoo,
    scale_by_sm3,
)

__all__ = [
    "Optimizer",
    "QuantPolicy",
    "FactoredMoment",
    "state_nbytes",
    "tree_order",
    "scale_by_sm3",
    "scale_by_factored_rms",
    "scale_by_shampoo",
    "adamw_chain",
    "adamw32",
    "adamw8bit",
    "adamw4bit",
    "factor4bit",
    "adafactor",
    "sm3",
    "sgdm",
    "sgdm4bit",
    "production4bit",
    "shampoo_chain",
    "shampoo32",
    "shampoo4bit",
    "constant",
    "linear_warmup_linear_decay",
    "linear_warmup_cosine",
    "OPTIMIZER_SPECS",
    "make_optimizer",
    "optimizer_names",
    "M_4BIT",
    "V_4BIT",
    "M_8BIT",
    "V_8BIT",
    "FACTOR_4BIT",
]


class OptimizerSpec(NamedTuple):
    factory: Callable[..., Optimizer]
    description: str
    forwards_to: Optional[Callable[..., Optimizer]] = None


OPTIMIZER_SPECS: Dict[str, OptimizerSpec] = {
    "adamw32": OptimizerSpec(adamw32, "32-bit AdamW (no compression)", quantized_adamw),
    "adamw8bit": OptimizerSpec(
        adamw8bit, "8-bit AdamW baseline, B2048/DE, embeddings fp32", quantized_adamw
    ),
    "adamw4bit": OptimizerSpec(
        adamw4bit, "paper's 4-bit AdamW: m B128/DE, v Rank-1/Linear", quantized_adamw
    ),
    "factor4bit": OptimizerSpec(
        factor4bit, "paper's 4-bit Factor: m B128/DE, v factored for ndim>=2", quantized_adamw
    ),
    "adafactor": OptimizerSpec(adafactor, "Adafactor baseline (factored v)"),
    "sm3": OptimizerSpec(sm3, "SM3 baseline (sublinear accumulators)"),
    "sgdm": OptimizerSpec(sgdm, "SGD with momentum (Alg. 2 accumulator form)"),
    "sgdm4bit": OptimizerSpec(sgdm4bit, "4-bit SGDM with stochastic rounding", sgdm),
    "production4bit": OptimizerSpec(
        production4bit, "production preset: fp32 embed/head/norm/bias + 4-bit SR body"
    ),
    "shampoo32": OptimizerSpec(
        shampoo32, "fp32 blocked Shampoo with AdamW grafting (parity oracle)", shampoo_chain
    ),
    "shampoo4bit": OptimizerSpec(
        shampoo4bit, "4-bit Shampoo: B128/Dyn Kronecker factors + 4-bit AdamW moments",
        shampoo_chain,
    ),
}


def optimizer_names() -> Tuple[str, ...]:
    return tuple(OPTIMIZER_SPECS)


def make_optimizer(name: str, lr, **overrides) -> Optimizer:
    """Build a registered optimizer; unknown names or overrides raise
    ``ValueError`` listing the valid choices."""
    spec = OPTIMIZER_SPECS.get(name)
    if spec is None:
        close = difflib.get_close_matches(str(name), OPTIMIZER_SPECS, n=1)
        hint = f" — did you mean {close[0]!r}?" if close else ""
        raise ValueError(
            f"unknown optimizer {name!r}; available: {', '.join(OPTIMIZER_SPECS)}{hint}"
        )
    valid = set()
    fn = spec.factory
    while fn is not None:  # follow the **kw forwarding chain
        sig = inspect.signature(fn)
        valid |= {
            p.name for p in sig.parameters.values()
            if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY)
            and p.name != "lr"
        }
        has_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values())
        fn = spec.forwards_to if (has_var_kw and fn is spec.factory) else None
    unknown = set(overrides) - valid
    if unknown:
        raise ValueError(
            f"optimizer {name!r} does not accept override(s) {sorted(unknown)}; "
            f"valid overrides: {sorted(valid)}."
        )
    try:
        return spec.factory(lr, **overrides)
    except TypeError as e:
        raise ValueError(f"optimizer {name!r} rejected overrides: {e}") from None

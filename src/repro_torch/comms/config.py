"""CommsConfig: the one gradient-compression knob (``--grad-comm``), port of
``repro/comms/config.py``.

Four wire formats for the gradients: ``fp32`` (as they are), ``bf16`` (cast
before transport, half the bytes), ``int8`` and ``int4`` (block-wise
quantized transport: codes plus one fp32 absmax scale per ``block_size``
elements, stochastic rounding keyed off the checkpointed key stream when
the train state carries a key). Leaves with at most ``threshold`` elements
always move fp32 (paper App. D.1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import mappings
from repro_torch.core.quantizer import QuantConfig

__all__ = ["GRAD_COMM_MODES", "GRAD_COMM_KEY_DOMAIN", "CommsConfig"]

GRAD_COMM_MODES = ("fp32", "bf16", "int8", "int4")

# Domain tag folded into the per-step SR key before the per-leaf folds, so
# the transport noise never collides with the optimizer-state SR stream
# (which folds small leaf indices into the same step key).
GRAD_COMM_KEY_DOMAIN = 0x67726164  # ASCII "grad"


@dataclasses.dataclass(frozen=True)
class CommsConfig:
    """Static description of the gradient wire format (hashable)."""

    mode: str = "fp32"
    block_size: int = 128
    mapping: str = "de"  # signed map with a zero code
    stochastic_rounding: bool = True
    threshold: int = 4096  # leaves <= threshold elements move fp32

    def __post_init__(self):
        if self.mode not in GRAD_COMM_MODES:
            raise ValueError(
                f"unknown grad-comm mode {self.mode!r}; want one of {GRAD_COMM_MODES}"
            )
        # validated for every mode, so a typo fails at construction
        mappings.get_spec(self.mapping)

    @classmethod
    def parse(cls, mode: str, **overrides) -> "CommsConfig":
        """Build from the CLI spelling (``--grad-comm int4``)."""
        return cls(mode=str(mode).lower(), **overrides)

    @property
    def bits(self) -> Optional[int]:
        return {"int8": 8, "int4": 4}.get(self.mode)

    @property
    def quantized(self) -> bool:
        return self.mode in ("int8", "int4")

    @property
    def compresses(self) -> bool:
        """Any mode that changes what moves through the collective."""
        return self.mode != "fp32"

    @property
    def cast_dtype(self):
        return torch.bfloat16 if self.mode == "bf16" else None

    def quant_config(self) -> Optional[QuantConfig]:
        """The ``core.quantizer`` config of the transport quantizer."""
        if not self.quantized:
            return None
        return QuantConfig(bits=self.bits, normalization="blockwise", block_size=self.block_size,
                           mapping=self.mapping, signed=True,
                           stochastic_rounding=self.stochastic_rounding,
                           threshold=self.threshold)

    @property
    def name(self) -> str:
        if not self.quantized:
            return self.mode
        sr = "+SR" if self.stochastic_rounding else ""
        return f"{self.mode}/B{self.block_size}/{self.mapping.upper()}{sr}"

"""Nibble packing: two 4-bit codes per uint8, packed along the last axis.

Port of ``repro/core/packing.py``: low nibble = even index, high nibble = odd
index, so a (n, m) code tensor packs to (n, ceil(m/2)); odd last dims are
zero-padded and callers track the logical size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["pack4", "unpack4", "packed_last_dim"]


def packed_last_dim(last: int) -> int:
    return (last + 1) // 2


def pack4(codes: torch.Tensor) -> torch.Tensor:
    """Pack uint8 4-bit codes (values < 16) pairwise along the last axis."""
    if codes.shape[-1] % 2:
        codes = F.pad(codes, (0, 1))
    lo = codes[..., 0::2].to(torch.uint8)
    hi = codes[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack4(packed: torch.Tensor, last: int) -> torch.Tensor:
    """Unpack bytes back into uint8 codes with logical last dim ``last``."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    interleaved = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    return interleaved[..., :last]

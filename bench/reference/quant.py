"""The paper's two 4-bit quantizers in plain torch: B128/DE (signed
dynamic-exponent table, absmax per block of 128 row-major elements) for the
first moment and Rank-1/Linear (unsigned linear table without zero, the
per-element scale the least of the per-dim absmax statistics) for the
second, with round-to-nearest or stochastic rounding.

Codes are kept unpacked, one uint8 per element; the statistics as the
optimizer stores them (block scales guarded to 1 where a block is zero,
rank-1 maxima unguarded, guarded where they are used). The optimizer's
initial zeros round to nearest: m to the table's 0, v to its least point.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

BLOCK = 128


def _de_fraction_levels(F: int) -> np.ndarray:
    j = np.arange(2**F + 1, dtype=np.float64)
    p = (1.0 - 0.1) / (2**F) * j + 0.1
    return (p[:-1] + p[1:]) / 2.0


def _de_magnitudes(width: int) -> np.ndarray:
    """Dynamic-exponent values of ``width``-bit codes: code 0 is 0.0, code c
    is 10^-E * fraction[F] with E the leading zeros of c and F the bits
    after its first one."""
    values = np.zeros(2**width, dtype=np.float64)
    for code in range(1, 2**width):
        bits = format(code, f"0{width}b")
        E = len(bits) - len(bits.lstrip("0"))
        frac_bits = bits[E + 1:]
        k = int(frac_bits, 2) if frac_bits else 0
        values[code] = (10.0**-E) * _de_fraction_levels(len(frac_bits))[k]
    return values


@functools.lru_cache(maxsize=None)
def _table_np(name: str) -> np.ndarray:
    if name == "de_signed":  # 3 magnitude bits; the pattern of -0 stands for +1.0
        mag = _de_magnitudes(3)
        vals = np.concatenate([mag, np.array([1.0]), -mag[1:]])
    elif name == "linear_unsigned":
        vals = (np.arange(16, dtype=np.float64) + 1) / 16
    else:
        raise ValueError(f"no table {name!r}")
    return np.sort(np.unique(vals)).astype(np.float32)


def table(name: str, device) -> torch.Tensor:
    return torch.from_numpy(_table_np(name).copy()).to(device)


def guard(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s > 0, s, torch.ones_like(s))


def encode_stochastic(n: torch.Tensor, t: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Round to one of the two table points around ``n``, the upper with
    probability proportional to nearness, decided by uniforms ``u``."""
    k = t.shape[0]
    ge = torch.zeros(n.shape, dtype=torch.int64, device=n.device)
    for j in range(k):
        ge += n >= t[j]
    lo = torch.clamp(ge - 1, 0, k - 2)
    t_lo, t_hi = t[lo], t[lo + 1]
    p_hi = torch.clamp((n - t_lo) / torch.clamp_min(t_hi - t_lo, 1e-12), 0.0, 1.0)
    return (lo + (u < p_hi)).to(torch.uint8)


def block_scales(x: torch.Tensor) -> torch.Tensor:
    """Guarded absmax of each flat block of 128 (the last padded with zeros)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return guard(torch.amax(torch.abs(flat.reshape(-1, BLOCK)), dim=1))


def per_block(scales: torch.Tensor, n: int) -> torch.Tensor:
    """Flat per-element scale of ``n`` elements from block scales."""
    return torch.repeat_interleave(scales, BLOCK)[:n]


def block_range(scales: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Per-element scales of flat elements ``[a, b)``, ``a`` a multiple of 128."""
    return torch.repeat_interleave(scales[a // BLOCK:-(-b // BLOCK)], BLOCK)[:b - a]


def rank1_stats(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-dim absmax (a 1-d tensor: its absmax, as a (1,) tensor)."""
    a = torch.abs(x)
    if x.ndim <= 1:
        return (torch.amax(a).reshape(1),)
    return tuple(torch.amax(a, dim=tuple(i for i in range(x.ndim) if i != r))
                 for r in range(x.ndim))


def rank1_scale(stats: Tuple[torch.Tensor, ...], shape) -> torch.Tensor:
    """Per-element scale: the least of the broadcast statistics, guarded."""
    if len(shape) <= 1:
        return guard(stats[0][0]).expand(shape)
    scale = None
    for r, st in enumerate(stats):
        view = [1] * len(shape)
        view[r] = shape[r]
        b = st.reshape(view)
        scale = b if scale is None else torch.minimum(scale, b)
    return guard(scale.expand(tuple(shape)))


def decode(codes: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return t[codes.long()]

"""Normalization operators N: scale tensor entries into the unit interval.

Port of ``repro/core/normalization.py``: per-tensor, block-wise (row-major
flattened blocks) and rank-1 (per-dim absmax stats, per-element scale = min
over dims; 1-d falls back to per-tensor). All are signed-safe and return
``(normalized, scales)``; each ``*_denorm`` maps stored scales back to a
per-element scale.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "pertensor_normalize",
    "pertensor_denorm",
    "blockwise_normalize",
    "blockwise_denorm",
    "rank1_normalize",
    "rank1_denorm",
    "blockwise_num_blocks",
]


def _guard(s: torch.Tensor) -> torch.Tensor:
    """Avoid division by zero for all-zero tensors/blocks/rows."""
    return torch.where(s > 0, s, torch.ones_like(s))


def pertensor_normalize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    s = _guard(torch.amax(torch.abs(x)))
    return x / s, s[None]  # scales shape (1,)


def pertensor_denorm(scales: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    return scales[0].expand(shape)


def blockwise_num_blocks(size: int, block: int) -> int:
    return -(-size // block)


def blockwise_normalize(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-major flattened block-wise absmax normalization.

    Returns (normalized (same shape as x), scales (num_blocks,)).
    """
    flat = x.reshape(-1)
    n = flat.shape[0]
    nb = blockwise_num_blocks(n, block)
    pad = nb * block - n
    blocks = (F.pad(flat, (0, pad)) if pad else flat).reshape(nb, block)
    s = _guard(torch.amax(torch.abs(blocks), dim=1))  # (nb,)
    normed = (blocks / s[:, None]).reshape(-1)[:n].reshape(x.shape)
    return normed, s


def blockwise_denorm(scales: torch.Tensor, shape: Tuple[int, ...], block: int) -> torch.Tensor:
    """Per-element scale array from block scales."""
    n = 1
    for d in shape:
        n *= d
    per_elem = torch.repeat_interleave(scales, block)[:n]
    return per_elem.reshape(shape)


def rank1_normalize(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Rank-1 normalization (App. G): stats[r] is the absmax over all dims
    but r; the per-element scale is min_r stats[r][i_r]. 1-d is per-tensor."""
    if x.ndim <= 1:
        normed, s = pertensor_normalize(x)
        return normed, (s,)
    a = torch.abs(x)
    stats = []
    for r in range(x.ndim):
        axes = tuple(i for i in range(x.ndim) if i != r)
        stats.append(torch.amax(a, dim=axes))  # (d_r,)
    del a
    scale = rank1_denorm(tuple(stats), tuple(x.shape))
    return x / scale, tuple(stats)


def rank1_denorm(stats: Tuple[torch.Tensor, ...], shape: Tuple[int, ...]) -> torch.Tensor:
    """Per-element scale = min over dims of broadcast per-dim statistics."""
    if len(shape) <= 1:
        return _guard(stats[0][0]).expand(shape)
    scale = None
    for r, stat in enumerate(stats):
        view = [1] * len(shape)
        view[r] = shape[r]
        b = stat.reshape(view)
        scale = b if scale is None else torch.minimum(scale, b)
    return _guard(scale.expand(shape))

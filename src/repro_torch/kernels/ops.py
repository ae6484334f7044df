"""Leaf-level entry of the fused 4-bit AdamW step.

Port of ``repro/kernels/ops.py::fused_adamw4_leaf``, the integration point of
``FusedAdamWRoute``: it takes a (param, grad, QuantizedTensor m,
QuantizedTensor v) leaf and runs the step as two kernel launches over all
stacked slices ``(L, R, C)``: pass 1 (``adamw4bit.rank1_new_stats``)
reduces the updated v to its new rank-1 stats without writing it, as the
reference's XLA fusion does, and pass 2 (``adamw4bit.fused_adamw4``) runs
dequant -> AdamW -> requant.

Leading-dim rank-1 stats fold into the row stat (``min`` is associative),
so every slice sees the kernel's ``min(row, col)`` contract with per-slice
row stats ``(L, R)`` and shared column stats ``(C,)``. Stochastic rounding:
slice ``l`` is keyed by ``fold_in(leaf_key, l)``; the seed rows are derived
on the host (no device work, no synchronisation).

On a mesh (``sharding.context``), ``p`` is a rank's tile of the leaf: the
tile's slices, rows ``[r0, r1)`` and columns ``[c0, c1)`` (``c0`` and the
width multiples of 128, so B128 blocks stay whole). The moments come in the
mesh step's working layout: codes of the tile, the whole leaf's scales. Pass
1 runs on the tile and its per-dim maxima are merged over the ranks
(NaN-propagating max) before pass 2, which runs on the tile with the whole
leaf's seed rows and SR counters; the tile's new m scales are merged into
the whole leaf's. The route was chosen by the whole leaf's shape.

Dispatch follows the tensors: a CUDA leaf launches the CUDA kernels
(``adamw4bit.LAUNCHES`` counts launches of both passes, in place of the
reference's ``count_pallas_calls``), a CPU leaf takes the plain versions.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.quantizer import QuantizedTensor
from repro_torch.kernels.adamw4bit import LAUNCHES, fused_adamw4, rank1_new_stats
from repro_torch.kernels.sr import threefry2x32

__all__ = ["fused_adamw4_leaf", "leaf_operands", "seed_rows", "tile_stats", "tile_update",
           "merged_maxima", "LAUNCHES"]

_BLOCK = 128


def _rank1_slice_stats(stats: Tuple[torch.Tensor, ...], shape: Tuple[int, ...]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-dim rank-1 stats -> per-slice (L, R) row stats + shared (C,) cols."""
    lead_shape = shape[:-2]
    row, col = stats[-2], stats[-1]
    if not lead_shape:
        return row[None, :], col
    lead = None
    for r, st in enumerate(stats[:-2]):
        view = [1] * len(lead_shape)
        view[r] = lead_shape[r]
        b = st.reshape(view)
        lead = b if lead is None else torch.minimum(lead, b)
    lead = lead.expand(lead_shape).reshape(-1)  # (L,)
    return torch.minimum(lead[:, None], row[None, :]), col


def seed_rows(key: Tuple[int, int], L: int) -> torch.Tensor:
    """(L, 2) int64 key words on the host: row ``l`` = ``fold_in(key, l)``."""
    w0, w1 = threefry2x32(key[0], key[1], 0, torch.arange(L, dtype=torch.int64))
    return torch.stack([w0, w1], dim=1)


def leaf_operands(p, g, m_s: QuantizedTensor, v_s: QuantizedTensor, b2: float,
                  key: Optional[Tuple[int, int]] = None):
    """A leaf's operands for ``adamw4bit.fused_adamw4`` as a dict of keyword
    arguments, plus the new rank-1 stats of v (per dim) from pass 1."""
    shape = tuple(p.shape)
    R, C = shape[-2], shape[-1]
    L = p.numel() // (R * C)
    use_sr = bool(m_s.config.stochastic_rounding) and key is not None
    # host tables: free for the CUDA launch, moved by the plain version
    m_table = m_s.config.table("cpu")
    v_table = v_s.config.table("cpu")
    g3 = g.to(torch.float32).reshape(L, R, C)
    v_packed = v_s.codes.reshape(L, R, C // 2)
    v_r, v_c = (x.contiguous() for x in _rank1_slice_stats(v_s.scales, shape))
    # rank-1 stats of the UPDATED v: b2 * v + ((1 - b2) * g) * g
    new_stats = rank1_new_stats(v_packed, v_r, v_c, g3, v_table, b2, shape)
    v_r_new, v_c_new = _rank1_slice_stats(new_stats, shape)
    operands = dict(
        w=p.reshape(L, R, C), g=g3,
        m_packed=m_s.codes.reshape(L, R, C // 2),
        m_scale=m_s.scales[0].reshape(L, R, C // _BLOCK),
        v_packed=v_packed, v_r=v_r, v_c=v_c,
        v_r_new=v_r_new.contiguous(), v_c_new=v_c_new.contiguous(),
        m_table=m_table, v_table=v_table,
        sr_seed=seed_rows(key, L) if use_sr else None, use_sr=use_sr,
    )
    return operands, new_stats


def fused_adamw4_leaf(
    p: torch.Tensor,
    g: torch.Tensor,
    m_s: QuantizedTensor,
    v_s: QuantizedTensor,
    lr: float,
    b1: float,
    b2: float,
    eps: float,
    weight_decay: float,
    bc1: float,
    bc2: float,
    key: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, QuantizedTensor, QuantizedTensor]:
    """One fused AdamW step for an ndim>=2 leaf with 4-bit B128 m and 4-bit
    rank-1 v; ``p`` is updated in place and returned. ``key`` turns on
    in-kernel stochastic rounding when the configs ask for it (no key =>
    round-to-nearest, as ``quantize()`` falls back). ``lr``/``bc1``/``bc2``
    are host fp32 values."""
    from repro_torch.sharding.context import current_tile

    tile = current_tile()
    if tile is not None:
        return _tile_leaf(tile, p, g, m_s, v_s, lr, b1, b2, eps, weight_decay, bc1, bc2, key)
    operands, new_stats = leaf_operands(p, g, m_s, v_s, b2, key)
    _, mp3, ms3, vp3 = fused_adamw4(
        **operands, lr=lr, bc1=bc1, bc2=bc2,
        b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, out=operands["w"],
    )
    m2 = QuantizedTensor(mp3.reshape(m_s.codes.shape), (ms3.reshape(m_s.scales[0].shape),),
                         m_s.shape, m_s.config)
    v2 = QuantizedTensor(vp3.reshape(v_s.codes.shape), new_stats, v_s.shape, v_s.config)
    return p, m2, v2


def merged_maxima(parts: Tuple[torch.Tensor, ...], box, shape) -> Tuple[torch.Tensor, ...]:
    """Per-dim maxima of a tile, placed in the whole leaf's dims and merged
    over the ranks (every value is >= 0 or NaN, so 0 is the identity)."""
    from repro_torch.comms.collectives import merge_max

    out = []
    for st, (lo, hi), n in zip(parts, box, shape):
        full = torch.zeros(n, dtype=torch.float32, device=st.device)
        full[lo:hi] = st
        out.append(merge_max(full))
    return tuple(out)


def _tile_geometry(tile, p):
    shape, box = tile.shape, tile.box
    R, C = shape[-2], shape[-1]
    (r0, r1), (c0, c1) = box[-2], box[-1]
    if (c1 - c0) % _BLOCK or c0 % _BLOCK:
        raise ValueError(f"fused_adamw4: the tile {box} of a leaf of shape {shape} cuts B128 "
                         f"blocks (columns must start and end at multiples of {_BLOCK})")
    from repro_torch.kernels.sr import flat_indices

    slices = flat_indices(shape[:-2], box[:-2], "cpu").reshape(-1)  # global slice ids
    return slices, r0, r1, c0, c1, R, C


def tile_stats(tile, g: torch.Tensor, v_s: QuantizedTensor, b2: float) -> Tuple[torch.Tensor, ...]:
    """Pass 1 on a rank's tile (``v_s``: the tile's codes, the whole leaf's
    stats): the per-dim maxima of the updated v over the tile, in the tile's
    extents. Merged over the tiles (max) they are the whole leaf's."""
    slices, r0, r1, c0, c1, _, _ = _tile_geometry(tile, g)
    Lt, Rt, Ct = slices.numel(), r1 - r0, c1 - c0
    local = tile.local_shape
    v_r, v_c = (x.contiguous() for x in _rank1_slice_stats(
        tuple(s[lo:hi] for s, (lo, hi) in zip(v_s.scales, tile.box)), local))
    return rank1_new_stats(v_s.codes.reshape(Lt, Rt, Ct // 2), v_r, v_c,
                           g.to(torch.float32).reshape(Lt, Rt, Ct), v_s.config.table("cpu"), b2,
                           local)


def tile_update(tile, p, g, m_s: QuantizedTensor, v_s: QuantizedTensor, new_stats,
                lr, b1, b2, eps, weight_decay, bc1, bc2, key=None):
    """Pass 2 on a rank's tile with the whole leaf's new stats ``new_stats``:
    the tile's slices keep their seed rows and its elements their SR
    counters. ``p`` is updated in place. Returns (p, m codes, the tile's m
    scales (Lt, Rt, Ct / 128), v codes, the flat indices of those scales in
    the whole leaf's scale vector)."""
    slices, r0, r1, c0, c1, R, C = _tile_geometry(tile, p)
    Lt, Rt, Ct = slices.numel(), r1 - r0, c1 - c0
    local, box = tile.local_shape, tile.box
    blk = ((slices[:, None, None] * R + torch.arange(r0, r1)[None, :, None]) * (C // _BLOCK)
           + torch.arange(c0 // _BLOCK, c1 // _BLOCK)[None, None, :]).to(p.device)
    v_r, v_c = _rank1_slice_stats(tuple(s[lo:hi] for s, (lo, hi) in zip(v_s.scales, box)),
                                  local)
    v_r_new, v_c_new = _rank1_slice_stats(
        tuple(s[lo:hi] for s, (lo, hi) in zip(new_stats, box)), local)
    use_sr = bool(m_s.config.stochastic_rounding) and key is not None
    seeds = seed_rows(key, math.prod(tile.shape[:-2]))[slices] if use_sr else None
    w3 = p.reshape(Lt, Rt, Ct)
    _, mp3, ms3, vp3 = fused_adamw4(
        w3, g.to(torch.float32).reshape(Lt, Rt, Ct), m_s.codes.reshape(Lt, Rt, Ct // 2),
        m_s.scales[0][blk].contiguous(), v_s.codes.reshape(Lt, Rt, Ct // 2), v_r.contiguous(),
        v_c.contiguous(), v_r_new.contiguous(), v_c_new.contiguous(), m_s.config.table("cpu"),
        v_s.config.table("cpu"), lr, bc1, bc2, seeds,
        b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, use_sr=use_sr, out=w3,
        tile=(r0, c0, C),
    )
    return p, mp3, ms3, vp3, blk


def _tile_leaf(tile, p, g, m_s, v_s, lr, b1, b2, eps, weight_decay, bc1, bc2, key):
    from repro_torch.comms.collectives import merge_max

    new_stats = merged_maxima(tile_stats(tile, g, v_s, b2), tile.box, tile.shape)
    p, mp3, ms3, vp3, blk = tile_update(tile, p, g, m_s, v_s, new_stats, lr, b1, b2, eps,
                                        weight_decay, bc1, bc2, key)
    m_scale = torch.zeros_like(m_s.scales[0])
    m_scale[blk] = ms3
    m2 = QuantizedTensor(mp3.reshape(m_s.codes.shape), (merge_max(m_scale),), m_s.shape,
                         m_s.config)
    v2 = QuantizedTensor(vp3.reshape(v_s.codes.shape), new_stats, v_s.shape, v_s.config)
    return p, m2, v2

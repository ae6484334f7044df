"""Optimizer interface + the compression framework of Alg. 1.

Port of ``repro/core/optimizers/base.py``. A parameter tree is an ordered
``{path: tensor}`` mapping whose order is the reference's leaf order
(``tree_order``), so leaf indices — and with them the stochastic-rounding
key stream — are the reference's. State moments are stored compressed
(``QuantizedTensor``), factored (``FactoredMoment``) or raw fp32, decided
per leaf at init by a ``QuantPolicy``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.quantizer import QuantConfig, QuantizedTensor, dequantize, quantize

__all__ = [
    "Optimizer",
    "QuantPolicy",
    "FactoredMoment",
    "compress_moment",
    "decompress_moment",
    "tree_order",
    "state_nbytes",
]

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    """A gradient-based optimizer as an (init, update) pair."""

    init: Callable[[Params], Any]
    update: Callable[..., Tuple[Params, Any]]
    name: str = "optimizer"


def _path_key(path: str):
    # list indices order numerically, dict keys as strings (jax's flattening)
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c) for c in path.split("/"))


def tree_order(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The mapping re-ordered as the reference flattens the nested tree:
    dict keys sorted, list entries by index. Its keys are what the
    reference's ``tree_paths`` gives, in its leaf order."""
    return {k: params[k] for k in sorted(params, key=_path_key)}


class FactoredMoment:
    """Adafactor-style factored second moment over the trailing two dims:
    for a tensor of shape (..., n, m), ``row`` (..., n) and ``col`` (..., m)
    are its means over m and over n; the reconstruction is
    row ⊗ col / mean(row) (Shazeer & Stern, 2018).

    On a mesh (``tile``: the rank's ``sharding.context.Tile`` of the leaf)
    ``row`` and ``col`` stay whole and equal on every rank: the update
    merges the tile's partial sums over the ranks (each distinct box once)
    and divides by the whole leaf's m (or n), and the reconstruction is the
    whole one's at the tile's elements."""

    __slots__ = ("row", "col", "shape")

    def __init__(self, row: torch.Tensor, col: torch.Tensor, shape: Tuple[int, ...]):
        self.row = row
        self.col = col
        self.shape = tuple(shape)

    @staticmethod
    def zeros(shape: Tuple[int, ...], device=None) -> "FactoredMoment":
        shape = tuple(shape)
        return FactoredMoment(torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                              torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32,
                                          device=device), shape)

    def reconstruct(self, tile=None) -> torch.Tensor:
        """v̂ = row ⊗ col / mean(row); all-zero rows at t=0 are guarded."""
        denom = torch.clamp_min(torch.mean(self.row, dim=-1, keepdim=True), 1e-30)
        row, col = self.row / denom, self.col
        if tile is not None:
            box = tile.box
            row, col = row[_index(box[:-1])], col[_index(box[:-2] + box[-1:])]
        return row[..., :, None] * col[..., None, :]

    def ema_update(self, sq: torch.Tensor, b2: float, tile=None) -> "FactoredMoment":
        if tile is None:
            r_mean, c_mean = torch.mean(sq, dim=-1), torch.mean(sq, dim=-2)
        else:
            box, shape = tile.box, self.shape
            r_mean = _merged_mean(torch.sum(sq, dim=-1), box[:-1], shape[:-1], shape[-1], tile)
            c_mean = _merged_mean(torch.sum(sq, dim=-2), box[:-2] + box[-1:],
                                  shape[:-2] + shape[-1:], shape[-2], tile)
        row = b2 * self.row + (1 - b2) * r_mean
        col = b2 * self.col + (1 - b2) * c_mean
        return FactoredMoment(row, col, self.shape)

    def nbytes(self) -> int:
        return int(self.row.numel() * 4 + self.col.numel() * 4)

    def __repr__(self) -> str:  # pragma: no cover
        return f"FactoredMoment(shape={self.shape})"


def _index(box) -> Tuple[slice, ...]:
    return tuple(slice(a, b) for a, b in box)


def _merged_mean(part: torch.Tensor, box, shape, n: int, tile) -> torch.Tensor:
    """The whole leaf's mean over a dim of ``n`` from a tile's partial sums
    (``part``, the tile's ``box`` of a ``shape`` vector): placed in the
    whole vector, summed over the ranks (each distinct box once), divided
    by ``n``."""
    from repro_torch.comms.collectives import merge_sum

    whole = torch.zeros(shape, dtype=torch.float32, device=part.device)
    whole[_index(box)] = part
    total = merge_sum(whole, take=tile.firsts())
    return total / torch.full((), float(n), dtype=torch.float32, device=part.device)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-leaf compression decision (paper App. D.1): leaves with <=
    ``threshold`` elements, of fewer than ``min_ndim`` dims (Shampoo's
    placeholders of vector params) or matching an ``exclude`` regex stay
    fp32; ``factor_2d`` factors the second moment of ndim >= 2 leaves
    (the 4-bit Factor optimizer)."""

    config: Optional[QuantConfig] = None
    threshold: int = 4096
    exclude: Tuple[str, ...] = ()
    factor_2d: bool = False
    min_ndim: int = 0

    def mode(self, path: str, shape: Tuple[int, ...]) -> str:
        """-> 'raw' | 'quant' | 'factor'."""
        size = 1
        for d in shape:
            size *= d
        if self.config is None and not self.factor_2d:
            return "raw"
        if size <= self.threshold or len(shape) < self.min_ndim:
            return "raw"
        if any(re.search(pat, path) for pat in self.exclude):
            return "raw"
        if self.factor_2d and len(shape) >= 2:
            return "factor"
        if self.config is None:
            return "raw"
        return "quant"


def compress_moment(x: torch.Tensor, mode: str, config: Optional[QuantConfig], key=None):
    """Alg. 1 line 5 for one leaf."""
    if mode == "quant":
        return quantize(x, config, key=key)
    return x.to(torch.float32)


def decompress_moment(s) -> torch.Tensor:
    """Alg. 1 line 3 for one leaf."""
    if isinstance(s, QuantizedTensor):
        return dequantize(s)
    if isinstance(s, FactoredMoment):
        return s.reconstruct()
    return s


def _leaves(node):
    if isinstance(node, (QuantizedTensor, FactoredMoment, torch.Tensor)):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (tuple, list)):
        for v in node:
            yield from _leaves(v)
    elif hasattr(node, "states"):  # ChainState / PartitionState
        yield from _leaves(node.states)


def state_nbytes(state) -> int:
    """Persistent bytes of an optimizer state (Tab. 4/5 accounting): packed
    codes and scales of quantized leaves, rows and columns of factored ones,
    raw tensors (step counts too)."""
    total = 0
    for leaf in _leaves(state):
        if isinstance(leaf, (QuantizedTensor, FactoredMoment)):
            total += leaf.nbytes()
        else:
            total += leaf.numel() * leaf.element_size()
    return int(total)

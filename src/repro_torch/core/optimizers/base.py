"""Optimizer interface + the compression framework of Alg. 1.

Port of ``repro/core/optimizers/base.py`` for the slice's optimizers. A
parameter tree is an ordered ``{path: tensor}`` mapping whose order is the
reference's leaf order (``tree_order``), so leaf indices — and with them
the stochastic-rounding key stream — are the reference's.
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


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-leaf compression decision (paper App. D.1): leaves with <=
    ``threshold`` elements, matching an ``exclude`` regex or of fewer than
    ``min_ndim`` dims stay fp32."""

    config: Optional[QuantConfig] = None
    threshold: int = 4096
    exclude: Tuple[str, ...] = ()
    min_ndim: int = 0

    def mode(self, path: str, shape: Tuple[int, ...]) -> str:
        """-> 'raw' | 'quant'."""
        size = 1
        for d in shape:
            size *= d
        if self.config is None or size <= self.threshold or len(shape) < self.min_ndim:
            return "raw"
        if any(re.search(pat, path) for pat in self.exclude):
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
    return s


def _leaves(node):
    if isinstance(node, (QuantizedTensor, torch.Tensor)):
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
    codes and scales of quantized leaves, raw tensors (step counts too)."""
    total = 0
    for leaf in _leaves(state):
        if isinstance(leaf, QuantizedTensor):
            total += leaf.nbytes()
        else:
            total += leaf.numel() * leaf.element_size()
    return int(total)

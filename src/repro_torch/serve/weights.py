"""Serving weight formats: bf16 cast or 4-bit block-quantized, with exact
byte accounting.

Port of ``repro/serve/weights.py``. ``prepare_params`` rewrites the fp32
master mapping ``{path: tensor}`` into the serving format:

* ``bf16`` — eligible leaves (rank >= 2, more than ``threshold`` elements,
  ``DEFAULT_THRESHOLD`` by default) cast to bf16; the others stay fp32.
* ``q4`` — the same eligible leaves stored as ``QuantizedTensor`` under
  B128/DE (blockwise-128 absmax scales, the signed dynamic-exponent map),
  quantized by the block-wise 4-bit kernel (``kernels.quant4``, launched on
  a CUDA leaf, its plain version on a CPU leaf).

The device copy stays packed; ``materialize`` dequantizes every
``QuantizedTensor`` to fp32 with the dequantize kernel, once per prefill and
once per decode chunk in the engine. The tensors are exactly
``core.quantizer.quantize(x, WEIGHT_Q4)``'s: codes packed along the last
axis, scales flat ``(n/128,)``. On a leaf whose last dim is a multiple of
128, or is even with a size that is a multiple of 128, that is the
kernels' ``(R, C)`` layout on a view of the flat array (``C`` the last dim
when it is a multiple of 128, else 128), and B2/B3 run on it. Any other
eligible leaf (an odd last dim, such as GPT-2's 50257-wide head, pads its
code rows with a zero nibble and its last scale block) takes the plain
``quantize``/``dequantize``; the route is chosen from the shape alone.

``weight_report`` is structural (shapes alone): per-leaf rows, totals and
the q4-vs-bf16 ratio.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.core.optimizers.base import tree_order
from repro_torch.core.quantizer import (
    QuantConfig,
    QuantizedTensor,
    dequantize,
    quantize,
    quantized_nbytes,
)
from repro_torch.kernels import quant4

__all__ = [
    "WEIGHT_Q4",
    "WEIGHT_MODES",
    "DEFAULT_THRESHOLD",
    "kernel_view",
    "prepare_params",
    "materialize",
    "weight_report",
    "format_weight_table",
]

# B128/DE: blockwise-128 absmax scales + the signed dynamic-exponent map.
WEIGHT_Q4 = QuantConfig(bits=4, normalization="blockwise", block_size=128, mapping="de",
                        signed=True)
WEIGHT_MODES = ("bf16", "q4")

# Same small-tensor cutoff the optimizer states use (App. D.1): leaves of at
# most this many elements, or of rank < 2, stay fp32.
DEFAULT_THRESHOLD = 4096


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _eligible(shape, threshold: int) -> bool:
    return len(shape) >= 2 and _numel(shape) > threshold


def _view(shape: Tuple[int, ...]) -> Optional[Tuple[int, int]]:
    n, last = _numel(shape), int(shape[-1])
    if last % 128 == 0:
        return n // last, last
    if last % 2 == 0 and n % 128 == 0:
        return n // 128, 128
    return None


def kernel_view(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """The kernels' (R, C) view of a leaf on which it equals ``quantize``'s
    layout (codes along the last axis, flat B128 scales)."""
    view = _view(shape)
    if view is None:
        raise ValueError(f"q4 weights: leaf of shape {tuple(shape)} has no (R, C) view with "
                         f"C % 128 == 0 and whole codes per row (odd last dim or size not a "
                         f"multiple of 128)")
    return view


def _check_mode(mode: str) -> None:
    if mode not in WEIGHT_MODES:
        raise ValueError(f"unknown weights mode {mode!r}; want one of {WEIGHT_MODES}")


def _quantize_leaf(x: torch.Tensor) -> QuantizedTensor:
    shape = tuple(x.shape)
    view = _view(shape)
    if view is None:
        return quantize(x.to(torch.float32), WEIGHT_Q4)
    R, C = view
    codes, scales = quant4.quantize_blockwise_4bit(x.reshape(R, C), WEIGHT_Q4.table("cpu"))
    return QuantizedTensor(codes.reshape(shape[:-1] + (shape[-1] // 2,)), (scales.reshape(-1),),
                           shape, WEIGHT_Q4)


def _dequantize_leaf(q: QuantizedTensor) -> torch.Tensor:
    view = _view(q.shape)
    if view is None:
        return dequantize(q)
    R, C = view
    x = quant4.dequantize_blockwise_4bit(q.codes.reshape(R, C // 2),
                                         q.scales[0].reshape(R, C // 128),
                                         q.config.table("cpu"))
    return x.reshape(q.shape)


@torch.no_grad()
def prepare_params(params: Mapping[str, torch.Tensor], mode: str, *,
                   threshold: int = DEFAULT_THRESHOLD) -> Dict[str, Any]:
    """fp32 masters ``{path: tensor}`` -> serving mapping (bf16 tensors or
    q4 ``QuantizedTensor``s for eligible leaves, fp32 for the rest)."""
    _check_mode(mode)
    out: Dict[str, Any] = {}
    for path, leaf in params.items():
        leaf = leaf.detach()
        if not _eligible(leaf.shape, threshold):
            out[path] = leaf.to(torch.float32)
        elif mode == "bf16":
            out[path] = leaf.to(torch.bfloat16)
        else:
            out[path] = _quantize_leaf(leaf)
    return out


@torch.no_grad()
def materialize(serving_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Dequantize every ``QuantizedTensor`` to an fp32 tensor (the packed
    copy stays as it is); other leaves pass through."""
    return {path: _dequantize_leaf(x) if isinstance(x, QuantizedTensor) else x
            for path, x in serving_params.items()}


def _leaf_bytes(shape, mode: str, threshold: int) -> int:
    if not _eligible(shape, threshold):
        return _numel(shape) * 4
    if mode == "bf16":
        return _numel(shape) * 2
    return quantized_nbytes(shape, WEIGHT_Q4)


def weight_report(params: Mapping[str, Any], mode: str, *,
                  threshold: int = DEFAULT_THRESHOLD) -> Dict:
    """Per-leaf and total weight bytes under a serving mode, from shapes
    alone (``params`` maps paths to anything with ``.shape``, e.g. tensors
    on the ``meta`` device)."""
    _check_mode(mode)
    rows: List[Dict[str, Any]] = []
    total = total_bf16 = quantized_leaves = 0
    for path, leaf in tree_order(params).items():
        shape = tuple(int(d) for d in leaf.shape)
        nbytes = _leaf_bytes(shape, mode, threshold)
        bf16 = _leaf_bytes(shape, "bf16", threshold)
        quantized = mode == "q4" and _eligible(shape, threshold)
        quantized_leaves += int(quantized)
        rows.append({"path": path, "shape": shape, "bf16_bytes": bf16,
                     "serve_bytes": nbytes, "quantized": quantized})
        total += nbytes
        total_bf16 += bf16
    return {
        "mode": mode,
        "format": WEIGHT_Q4.name if mode == "q4" else "bf16",
        "leaves": rows,
        "n_leaves": len(rows),
        "quantized_leaves": quantized_leaves,
        "total_bf16_bytes": int(total_bf16),
        "total_serve_bytes": int(total),
        "ratio_vs_bf16": round(total_bf16 / total, 4) if total else 1.0,
    }


def format_weight_table(reports: List[Dict], title: str = "") -> str:
    """Markdown weight-memory table."""
    lines = [f"### {title}", ""] if title else []
    lines += [
        "| --weights | format | weight bytes | vs bf16 | quantized leaves |",
        "|---|---|---|---|---|",
    ]
    for r in reports:
        lines.append(
            f"| {r['mode']} | {r['format']} | {r['total_serve_bytes']:,} "
            f"| {r['ratio_vs_bf16']:.2f}x fewer "
            f"| {r['quantized_leaves']}/{r['n_leaves']} |"
        )
    return "\n".join(lines)

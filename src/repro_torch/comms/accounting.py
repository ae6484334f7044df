"""Bytes-on-the-wire accounting for the gradients (port of
``repro/comms/accounting.py``): structural, from leaf shapes alone (tensors
on any device, ``meta`` included), per leaf and in total, fp32 against the
configured wire format."""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

from repro_torch.comms.config import GRAD_COMM_MODES, CommsConfig
from repro_torch.core.optimizers.base import tree_order
from repro_torch.core.quantizer import quantized_nbytes

__all__ = ["leaf_wire_bytes", "wire_report", "mode_totals", "format_wire_table"]


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def leaf_wire_bytes(shape: Tuple[int, ...], config: CommsConfig) -> Tuple[int, int]:
    """``(fp32_bytes, wire_bytes)`` of one gradient leaf: quantized modes
    move codes + fp32 block scales; leaves at or under the threshold (and
    every leaf in fp32/bf16 modes) move as raw casts."""
    n = _numel(shape)
    fp32 = n * 4
    qcfg = config.quant_config()
    if qcfg is not None and n > config.threshold:
        return fp32, quantized_nbytes(shape, qcfg)
    if config.cast_dtype is not None:
        return fp32, n * 2
    return fp32, fp32


def wire_report(grads: Mapping[str, object], config: CommsConfig) -> Dict:
    """Per-leaf and total gradient bytes of one train step; ``grads`` maps
    paths to anything with ``.shape`` (the params have the gradients'
    shapes)."""
    rows: List[Dict] = []
    total_fp32 = total_wire = quantized_leaves = 0
    qcfg = config.quant_config()
    for path, leaf in tree_order(grads).items():
        shape = tuple(int(d) for d in leaf.shape)
        fp32, wire = leaf_wire_bytes(shape, config)
        quantized = qcfg is not None and _numel(shape) > config.threshold
        quantized_leaves += int(quantized)
        rows.append({"path": path, "shape": shape, "fp32_bytes": fp32, "wire_bytes": wire,
                     "quantized": quantized})
        total_fp32 += fp32
        total_wire += wire
    return {
        "mode": config.mode,
        "name": config.name,
        "leaves": rows,
        "n_leaves": len(rows),
        "quantized_leaves": quantized_leaves,
        "total_fp32_bytes": int(total_fp32),
        "total_wire_bytes": int(total_wire),
        "ratio_vs_fp32": round(total_fp32 / total_wire, 4) if total_wire else 1.0,
    }


def mode_totals(grads, modes=GRAD_COMM_MODES) -> List[Dict]:
    """One ``wire_report`` per mode."""
    return [wire_report(grads, CommsConfig(mode=m)) for m in modes]


def format_wire_table(reports: List[Dict], title: str = "") -> str:
    """Markdown bytes-on-the-wire table."""
    lines = [f"### {title}", ""] if title else []
    lines += [
        "| grad-comm | wire format | collective bytes/step | vs fp32 | quantized leaves |",
        "|---|---|---|---|---|",
    ]
    for r in reports:
        lines.append(
            f"| {r['mode']} | {r['name']} | {r['total_wire_bytes']:,} "
            f"| {r['ratio_vs_fp32']:.2f}x fewer "
            f"| {r['quantized_leaves']}/{r['n_leaves']} |"
        )
    return "\n".join(lines)

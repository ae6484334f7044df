"""Roofline terms of a step (port of ``repro/roofline/analysis.py``):

    compute term    = FLOPs / peak FLOP/s              (per rank)
    memory term     = bytes / HBM bandwidth            (per rank)
    collective term = collective bytes / link bandwidth (per rank)

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and the
collective bytes from the optimized HLO; the port counts them on the
``meta`` device (``roofline.measured``) and records the mesh step's
collectives as they are called (``comms.collectives.recording``), priced
here with the same ring formulas (``_ring_bytes``, ``collective_bytes``).
The port's products run in more than one type (its training attention in
fp32, off the tensor cores), so a count may give its FLOPs by type
(``"flops by dtype"``), each priced at the card's rate for it. The
constants are the H100's; the port states no other card's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Mapping, Tuple

__all__ = ["HW", "H100", "hw_for_card", "RooflineTerms", "roofline_terms", "count_params",
           "model_flops", "collective_bytes", "KINDS", "_ring_bytes"]

# the reference's collective kinds (its HLO parse's)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


@dataclasses.dataclass(frozen=True)
class HW:
    """A card's peak rates (per card)."""

    peak_flops: float   # dense bf16 FLOP/s on the tensor cores
    hbm_bw: float       # B/s
    link_bw: float      # B/s, one way, per card
    fp32_flops: float = 0.0  # FP32 FLOP/s off the tensor cores (TF32 off)

    def flops_rate(self, dtype: str) -> float:
        """FLOP/s of products in ``dtype`` (a ``torch.dtype``'s name)."""
        if dtype in ("bfloat16", "float16"):
            return self.peak_flops
        if dtype == "float32" and self.fp32_flops > 0:
            return self.fp32_flops
        raise ValueError(f"no FLOP rate for {dtype} products")


# NVIDIA H100 Tensor Core GPU data sheet, H100 SXM (80 GB HBM3): 989.4
# TFLOP/s dense BF16 (1,979 with sparsity), 67 TFLOP/s FP32 (the port
# leaves TF32 off, PyTorch's default for matmuls), 3.35 TB/s memory
# bandwidth, NVLink 4 at 900 GB/s both ways (450 GB/s one way)
H100 = HW(peak_flops=989.4e12, hbm_bw=3.35e12, link_bw=450e9, fp32_flops=67e12)


def hw_for_card(name: str) -> HW:
    """The constants of the card ``nvidia-smi`` names; only the H100 SXM
    (``NVIDIA H100 80GB HBM3``) has them here. Another card raises: its
    constants are never guessed."""
    if "H100" in name and "HBM3" in name and "PCIe" not in name and "NVL" not in name:
        return H100
    raise ValueError(f"no roofline constants for the card {name!r} (only the H100 SXM 80GB "
                     "HBM3 has them)")


def _ring_bytes(kind: str, result_bytes: float, k: int) -> float:
    """Per-device link traffic under ring algorithms (the reference's
    choice): all-reduce 2(K-1)/K·R; all-gather (K-1)/K·R (R = gathered
    result); reduce-scatter (K-1)·R (operand is K×result); all-to-all
    (K-1)/K·R; collective-permute R."""
    if kind == "collective-permute":
        return result_bytes  # no group semantics; one hop of R bytes
    if k <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (k - 1) / k * result_bytes
    if kind == "all-gather":
        return (k - 1) / k * result_bytes
    if kind == "reduce-scatter":
        return float(k - 1) * result_bytes
    return (k - 1) / k * result_bytes  # all-to-all


def collective_bytes(calls: Iterable[Tuple[str, float, int]],
                     multiplier: float = 1.0) -> Dict[str, float]:
    """The reference's ``collective_bytes_from_hlo`` dict (per-device link
    bytes by kind, ``total``, ``ops``) of recorded ``(kind, result bytes,
    group size)`` calls (``comms.collectives.recording``)."""
    out: Dict[str, float] = {k: 0.0 for k in KINDS}
    out["total"], out["ops"] = 0.0, 0.0
    for kind, result_bytes, k in calls:
        b = _ring_bytes(kind, float(result_bytes), int(k)) * multiplier
        out[kind] += b
        out["total"] += b
        out["ops"] += 1.0
    return out


@dataclasses.dataclass
class RooflineTerms:
    flops: float               # per-rank FLOPs
    bytes_accessed: float      # per-rank bytes
    collective_bytes: float    # per-rank collective link bytes
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: float   # 6·N·D (global, useful work)
    useful_ratio: float        # model_flops / (flops × ranks)

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(cost: Mapping[str, Any], collective_bytes: float, n_chips: int,
                   model_flops_total: float, hw: HW = H100) -> RooflineTerms:
    """The three terms from ``cost`` (``flops``, ``bytes accessed``: the
    reference's keys), the bottleneck, and the useful share. With ``flops
    by dtype`` (``{dtype name: FLOPs}``, summing to ``flops``) each type's
    products are priced at its rate (``HW.flops_rate``); without it, every
    FLOP at ``peak_flops``, as the reference does."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    by_dtype = cost.get("flops by dtype")
    if by_dtype is None:
        compute_s = flops / hw.peak_flops
    else:
        compute_s = sum(float(f) / hw.flops_rate(d) for d, f in by_dtype.items())
    memory_s = bytes_accessed / hw.hbm_bw
    collective_s = collective_bytes / hw.link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops_total / (flops * n_chips) if flops > 0 else 0.0
    return RooflineTerms(
        flops=flops,
        bytes_accessed=bytes_accessed,
        collective_bytes=collective_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops_total=model_flops_total,
        useful_ratio=useful,
    )


def count_params(params: Mapping[str, Any], axes: Mapping[str, tuple]) -> Dict[str, float]:
    """(total, expert) parameter counts of a ``{path: tensor}`` mapping
    (``meta`` is enough) with its ``models.param_axes``: a leaf with an
    ``experts`` axis counts as expert weight."""
    total = 0
    expert = 0
    for k, p in params.items():
        n = 1
        for d in p.shape:
            n *= int(d)
        total += n
        if "experts" in axes[k]:
            expert += n
    return {"total": float(total), "expert": float(expert)}


def model_flops(cfg, params: Mapping[str, Any], axes: Mapping[str, tuple], shape_kind: str,
                tokens: int) -> float:
    """Useful-work FLOPs: 6·N_active·D for training, 2·N_active·D for
    inference (prefill per token; decode per generated token). Expert
    weights count ``top_k / num_experts`` of their size."""
    counts = count_params(params, axes)
    n_active = counts["total"] - counts["expert"]
    if cfg.num_experts > 0 and counts["expert"] > 0:
        n_active += counts["expert"] * cfg.top_k / cfg.num_experts
    factor = 6.0 if shape_kind == "train" else 2.0
    return factor * n_active * tokens

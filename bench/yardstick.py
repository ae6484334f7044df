"""The benchmark's yardstick: the card's published peaks, the useful work of
a training step, and the least bytes of the optimizer's update.

``model_flops_6n`` and the two ``b1_*_bytes`` byte models are frozen copies
of the program's ``roofline/analysis.py::model_flops`` and
``roofline/measured.py::b1_update_bytes`` / ``b1_stats_bytes``; the tests
hold them equal to the program's at every cell's shapes, so a drift shows.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

# NVIDIA H100 SXM 80 GB HBM3 data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def model_flops_6n(shapes: Dict[str, Tuple[int, ...]], top_k: int, n_experts: int,
                   tokens: int) -> float:
    """6 N_active D for a training step: a leaf with an experts axis (every
    leaf under ``moe/``, the router too, as the program counts it) counts
    ``top_k / n_experts`` of its size."""
    total = expert = 0
    for path, shape in shapes.items():
        n = math.prod(shape)
        total += n
        if "/moe/" in path:
            expert += n
    n_active = total - expert + (expert * top_k / n_experts if n_experts and expert else 0)
    return 6.0 * n_active * tokens


def attention_flops(layers: int, heads: int, head_dim: int, batch: int, seq: int) -> float:
    """The causal attention's products in a training step: q k^T and p v,
    2 B S^2 H dh each over the whole square, half of it causal, times 3 for
    the forward and the two products of the backward."""
    return 3.0 * 2 * (2.0 * batch * seq * seq * heads * head_dim) / 2 * layers


def b1_update_bytes(L: int, R: int, C: int) -> float:
    n = L * R * C
    read = n * (4 + 4 + 0.5 + 0.5) + n / 128 * 4 + (2 * L * R + 2 * C) * 4 + L * 2 * 4
    write = n * (4 + 0.5 + 0.5) + n / 128 * 4
    return read + write


def b1_stats_bytes(L: int, R: int, C: int) -> float:
    return L * R * C * (4 + 0.5) + 2 * (L * R + C) * 4


B1_BYTES = {"fused_adamw4": b1_update_bytes, "rank1_new_stats": b1_stats_bytes}
B1_KERNELS = ("fused_adamw4_kernel", "rank1_stats_kernel")


def update_least_bytes(leaves) -> float:
    """Least bytes of one optimizer update over ``leaves``: ``(parameter
    bytes, [moment bytes, ...])`` per leaf. The gradient (fp32) and the
    parameter are read once, the parameter written once, and every moment
    read once and written once, whatever implements the update."""
    total = 0.0
    for p_bytes, moments in leaves:
        total += p_bytes * 3 + 2 * sum(moments)
    return total

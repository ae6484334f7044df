"""The gradient wire format inside the train step (port of
``repro/comms/reduce.py`` for one device).

``reduce_grads`` with ``mesh=None`` applies the configured format to the
gradient mapping: ``fp32`` passes it through, ``bf16`` casts (the leaves
stay bf16 downstream), ``int8``/``int4`` quantize and dequantize each leaf
above the threshold (transport quantization, applied once per reduction).
With a key, the rounding is stochastic: leaf ``i`` draws
``sr.tensor_uniforms(fold_in(key, i), shape, STREAM_GRAD)``, counter = the
flat element index, so the noise is a pure function of (key, element), the
reference's bit for bit. The mesh path and ``quantized_all_reduce`` are
ROADMAP queue A item 5 (distributed) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.comms.config import GRAD_COMM_KEY_DOMAIN, CommsConfig
from repro_torch.core.optimizers.base import tree_order
from repro_torch.core.quantizer import QuantConfig, dequantize, quantize
from repro_torch.kernels import sr

__all__ = ["quantized_all_reduce", "reduce_grads", "grad_comm_key"]

Key = Tuple[int, int]
_NOT_PORTED = ("gradient collectives across devices are ROADMAP queue A item 5 (distributed); "
               "the port reduces on one device")


def grad_comm_key(base_key: Optional[Key], step: int) -> Optional[Key]:
    """Per-step transport SR key, ``fold_in(fold_in(key, step), DOMAIN)``: a
    pure function of the checkpointed (base key, step), apart from the
    optimizer-state stream ``fold_in(key, step)``."""
    if base_key is None:
        return None
    return sr.fold_in(sr.fold_in(base_key, int(step)), GRAD_COMM_KEY_DOMAIN)


def quantized_all_reduce(x: torch.Tensor, config: QuantConfig, axis_name, key=None):
    """The wire primitive of the mesh path; not ported yet."""
    raise NotImplementedError(_NOT_PORTED)


def _transport_quantize(g: torch.Tensor, qcfg: QuantConfig, key: Optional[Key]) -> torch.Tensor:
    """Quantize -> dequantize one leaf (codes and scales are what would
    move)."""
    u = (sr.tensor_uniforms(key, tuple(g.shape), sr.STREAM_GRAD, g.device)
         if key is not None and qcfg.stochastic_rounding else None)
    q = quantize(g.to(torch.float32), qcfg, uniforms=u)
    del u
    return dequantize(q)


@torch.no_grad()
def reduce_grads(grads: Dict[str, torch.Tensor], axes, mesh, config: CommsConfig, *,
                 key: Optional[Key] = None) -> Dict[str, torch.Tensor]:
    """Apply the configured wire format to ``{path: grad}``; leaf ``i`` of
    the reference's leaf order gets ``fold_in(key, i)``. ``key`` (from
    ``grad_comm_key``) turns on stochastic rounding; without it quantized
    modes round to nearest."""
    if mesh is not None or axes is not None:
        raise NotImplementedError(_NOT_PORTED)
    qcfg = config.quant_config()
    out = {}
    for i, (k, g) in enumerate(tree_order(grads).items()):
        if qcfg is not None and g.numel() > config.threshold:
            g = _transport_quantize(g, qcfg, sr.fold_in(key, i) if key is not None else None)
        elif config.cast_dtype is not None:
            g = g.to(config.cast_dtype)
        out[k] = g
    return out

"""Quantized gradient-collective primitives (port of ``repro/comms/reduce.py``).

``quantized_all_reduce(x, config, group, key=)`` is the wire primitive: each
rank of ``group`` block-quantizes its partial sum (SR noise from
``sr.fold_in(key, rank)`` on ``STREAM_GRAD``, counter = the flat element
index), the ranks all-gather the codes and scales (uint8 and fp32 on the
wire, not fp32 values), and every rank dequantizes each rank's part and sums
them in ascending rank order, so every rank returns the same bits.

``reduce_grads`` applies the configured wire format to a gradient mapping:
``fp32`` passes it through, ``bf16`` casts (the leaves stay bf16
downstream), ``int8``/``int4`` quantize and dequantize each leaf above the
threshold (transport quantization of the logical gradient, applied once per
reduction). With a key the rounding is stochastic: leaf ``i`` draws
``sr.tensor_uniforms(fold_in(key, i), shape, STREAM_GRAD)``, counter = the
flat element index of the whole leaf, so the noise is a pure function of
(key, element). On a mesh the mapping holds this rank's tiles of the
gradients in the ZeRO wire layout (``sharding.rules.wire_spec``; the mesh
train step makes them so): each tile is quantized with the whole leaf's
block statistics and the whole leaf's draw at its elements, so the result
is bit-identical for any mesh layout and without a mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.comms.collectives import all_gather
from repro_torch.comms.config import GRAD_COMM_KEY_DOMAIN, CommsConfig
from repro_torch.core.optimizers.base import tree_order
from repro_torch.core.quantizer import QuantConfig, QuantizedTensor, dequantize, quantize
from repro_torch.kernels import sr
from repro_torch.sharding import context
from repro_torch.sharding.rules import wire_spec

__all__ = ["quantized_all_reduce", "reduce_grads", "grad_comm_key"]

Key = Tuple[int, int]


def grad_comm_key(base_key: Optional[Key], step: int) -> Optional[Key]:
    """Per-step transport SR key, ``fold_in(fold_in(key, step), DOMAIN)``: a
    pure function of the checkpointed (base key, step), apart from the
    optimizer-state stream ``fold_in(key, step)``."""
    if base_key is None:
        return None
    return sr.fold_in(sr.fold_in(base_key, int(step)), GRAD_COMM_KEY_DOMAIN)


@torch.no_grad()
def quantized_all_reduce(x: torch.Tensor, config: QuantConfig, group=None,
                         key: Optional[Key] = None) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``group`` (a ``torch.distributed`` process
    group; ``None`` is the world) moving codes and scales, not fp32: returns
    ``sum_r dequantize(quantize(x_r))`` in ascending rank order, the same
    bits on every rank."""
    import torch.distributed as dist

    u = None
    if key is not None and config.stochastic_rounding:
        u = sr.tensor_uniforms(sr.fold_in(key, dist.get_rank(group)), tuple(x.shape),
                               sr.STREAM_GRAD, x.device)
    q = quantize(x, config, uniforms=u)
    codes = all_gather(q.codes, group)
    scales = [all_gather(s, group) for s in q.scales]
    out = None
    for r in range(codes.shape[0]):
        d = dequantize(QuantizedTensor(codes[r], tuple(s[r] for s in scales), tuple(x.shape),
                                       config))
        out = d if out is None else out + d
    return out


def _transport_quantize(g: torch.Tensor, qcfg: QuantConfig, key: Optional[Key]) -> torch.Tensor:
    """Quantize -> dequantize one leaf, or one tile of it inside the mesh
    context's leaf scope (codes and scales are what move)."""
    tile = context.current_tile()
    u = None
    if key is not None and qcfg.stochastic_rounding:
        shape, box = (tile.shape, tile.box) if tile is not None else (tuple(g.shape), None)
        u = sr.tensor_uniforms(key, shape, sr.STREAM_GRAD, g.device, box)
    q = quantize(g.to(torch.float32), qcfg, uniforms=u)
    del u
    return dequantize(q)


@torch.no_grad()
def reduce_grads(grads: Dict[str, torch.Tensor], axes, mesh, config: CommsConfig, *,
                 key: Optional[Key] = None) -> Dict[str, torch.Tensor]:
    """Apply the configured wire format to ``{path: grad}``; leaf ``i`` of
    the reference's leaf order gets ``fold_in(key, i)``. ``key`` (from
    ``grad_comm_key``) turns on stochastic rounding; without it quantized
    modes round to nearest.

    With ``mesh`` and ``axes``, ``grads`` holds this rank's wire tiles and
    the mesh context (``sharding.context.use``) must be active with a tile
    for every path; each tile is checked against ``wire_spec``."""
    run = None
    if mesh is not None and axes is not None:
        run = context.current_run()
        if run is None:
            raise ValueError("reduce_grads on a mesh: no mesh context is active "
                             "(sharding.context.use)")
    qcfg = config.quant_config()
    out = {}
    for i, (k, g) in enumerate(tree_order(grads).items()):
        n = g.numel()
        if run is not None:
            tile = context.tile_of(k)
            want = context.box_of(wire_spec(tile.shape, axes[k], run.sizes), tile.shape, run)
            if tile.box != want or tuple(g.shape) != tile.local_shape:
                raise ValueError(f"reduce_grads: {k} is not this rank's wire tile {want}")
            n = 1
            for d in tile.shape:
                n *= d
        if qcfg is not None and n > config.threshold:
            with context.leaf(k):
                g = _transport_quantize(g, qcfg, sr.fold_in(key, i) if key is not None else None)
        elif config.cast_dtype is not None:
            g = g.to(config.cast_dtype)
        out[k] = g
    return out

"""Quantizer Q = M ∘ N and the ``QuantizedTensor`` container.

Port of ``repro/core/quantizer.py``:

    codes = M_{T,b}( N(x) )         (compress)
    x~    = N^{-1}( T(codes) )      (decompress)

4-bit codes are stored nibble-packed along the last axis (two per uint8);
8-bit codes raw. Stochastic rounding draws from a JAX-compatible key
(``repro_torch.kernels.sr``) or from given uniforms, so codes are bit-equal
to the reference for the same key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import mappings, normalization, packing

__all__ = [
    "QuantConfig",
    "QuantizedTensor",
    "quantize",
    "dequantize",
    "quantized_nbytes",
    "state_bytes",
    "B2048_DE",
    "B128_DE",
    "B128_DE0",
    "RANK1_LINEAR",
]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static description of a quantizer; ``mapping`` must be registered."""

    bits: int = 4
    normalization: str = "blockwise"  # pertensor | blockwise | rank1
    block_size: int = 128
    mapping: str = "de"
    signed: bool = True
    stochastic_rounding: bool = False
    threshold: int = 4096

    def __post_init__(self):
        mappings.get_spec(self.mapping)  # raises listing mappings.registered()

    @property
    def name(self) -> str:
        norm = {
            "pertensor": "PerTensor",
            "blockwise": f"B{self.block_size}",
            "rank1": "Rank-1",
        }[self.normalization]
        mp = mappings.get_spec(self.mapping).display
        sr = "+SR" if self.stochastic_rounding else ""
        return f"{norm}/{mp}{sr}@{self.bits}bit"

    def table(self, device) -> torch.Tensor:
        return mappings.mapping_table(self.mapping, self.bits, self.signed, device)


# Paper-named quantizer presets.
B2048_DE = QuantConfig(normalization="blockwise", block_size=2048, mapping="de")
B128_DE = QuantConfig(normalization="blockwise", block_size=128, mapping="de")
B128_DE0 = QuantConfig(normalization="blockwise", block_size=128, mapping="de0", signed=False)
RANK1_LINEAR = QuantConfig(normalization="rank1", mapping="linear", signed=False)


class QuantizedTensor:
    """Compressed tensor: packed codes + normalization scales + static meta."""

    __slots__ = ("codes", "scales", "shape", "config")

    def __init__(self, codes: torch.Tensor, scales: Tuple[torch.Tensor, ...],
                 shape: Tuple[int, ...], config: QuantConfig):
        self.codes = codes
        self.scales = tuple(scales)
        self.shape = tuple(shape)
        self.config = config

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def nbytes(self) -> int:
        """Persistent storage cost in bytes (codes + scales)."""
        total = self.codes.numel() * self.codes.element_size()
        for s in self.scales:
            total += s.numel() * s.element_size()
        return int(total)

    def __repr__(self) -> str:  # pragma: no cover
        return f"QuantizedTensor(shape={self.shape}, {self.config.name})"


def _normalize(x: torch.Tensor, config: QuantConfig):
    if config.normalization == "pertensor":
        n, s = normalization.pertensor_normalize(x)
        return n, (s,)
    if config.normalization == "blockwise":
        n, s = normalization.blockwise_normalize(x, config.block_size)
        return n, (s,)
    if config.normalization == "rank1":
        n, stats = normalization.rank1_normalize(x)
        return n, tuple(stats)
    raise ValueError(f"unknown normalization {config.normalization!r}")


def _denorm_scale(scales, shape, config: QuantConfig) -> torch.Tensor:
    if config.normalization == "pertensor":
        return normalization.pertensor_denorm(scales[0], shape)
    if config.normalization == "blockwise":
        return normalization.blockwise_denorm(scales[0], shape, config.block_size)
    if config.normalization == "rank1":
        if len(shape) <= 1:
            return normalization.pertensor_denorm(scales[0], shape)
        return normalization.rank1_denorm(scales, shape)
    raise ValueError(f"unknown normalization {config.normalization!r}")


def _tile_of(x: torch.Tensor):
    """The mesh tile ``x`` is (``sharding.context``), or None."""
    from repro_torch.sharding.context import current_tile

    tile = current_tile()
    return tile if tile is not None and tuple(x.shape) == tile.local_shape else None


def _tile_normalize(x: torch.Tensor, config: QuantConfig, tile):
    """``_normalize`` of a rank's tile of a leaf: the statistics are the
    whole leaf's (each rank's partial maxima merged over the ranks), so the
    normalized values are the whole leaf's at the tile's elements; the
    scales returned are the whole leaf's."""
    from repro_torch.comms.collectives import merge_max
    from repro_torch.kernels.sr import flat_indices

    a = torch.abs(x)
    if config.normalization == "blockwise":
        n_all = 1
        for d in tile.shape:
            n_all *= d
        blk = flat_indices(tile.shape, tile.box, x.device) // config.block_size
        part = torch.zeros(normalization.blockwise_num_blocks(n_all, config.block_size),
                           dtype=torch.float32, device=x.device)
        part.scatter_reduce_(0, blk.reshape(-1), a.reshape(-1), "amax")
        part[blk[torch.isnan(x)]] = float("nan")
        s = normalization._guard(merge_max(part))
        return x / s[blk], (s,)
    if config.normalization == "pertensor" or (config.normalization == "rank1"
                                               and x.ndim <= 1):
        s = normalization._guard(merge_max(torch.amax(a)[None]))
        return x / s[0], (s,)
    if config.normalization == "rank1":
        stats = []
        for r, (lo, hi) in enumerate(tile.box):
            part = torch.zeros(tile.shape[r], dtype=torch.float32, device=x.device)
            part[lo:hi] = torch.amax(a, dim=tuple(i for i in range(x.ndim) if i != r))
            stats.append(merge_max(part))
        return x / _tile_denorm(tuple(stats), config, tile), tuple(stats)
    raise ValueError(f"unknown normalization {config.normalization!r}")


def _tile_denorm(scales, config: QuantConfig, tile) -> torch.Tensor:
    """Per-element scale of a tile from the whole leaf's scales."""
    from repro_torch.kernels.sr import flat_indices

    if config.normalization == "blockwise":
        blk = flat_indices(tile.shape, tile.box, scales[0].device) // config.block_size
        return scales[0][blk]
    local = tile.local_shape
    if config.normalization == "pertensor" or len(local) <= 1:
        return normalization._guard(scales[0][0]).expand(local)
    return normalization.rank1_denorm(tuple(s[lo:hi] for s, (lo, hi) in zip(scales, tile.box)),
                                      local)


def quantize(x: torch.Tensor, config: QuantConfig, key=None, *,
             uniforms: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """Compress a tensor. ``key`` (a ``sr`` key pair) drives stochastic
    rounding; ``uniforms`` (same shape as ``x``, in [0, 1)) overrides the
    draw. An SR config without either rounds to nearest (e.g. zeros at init).

    On a mesh, ``x`` may be this rank's tile of the leaf being updated
    (``sharding.context.current_tile``): the statistics are then the whole
    leaf's, the scales kept are the whole leaf's, and the SR draw is the
    whole leaf's at the tile's elements, so the codes are the whole leaf's
    codes at the tile.
    """
    x = x.to(torch.float32)
    tile = _tile_of(x)
    if tile is None:
        n, scales = _normalize(x, config)
    else:
        n, scales = _tile_normalize(x, config, tile)
        if config.stochastic_rounding and uniforms is None and key is not None:
            from repro_torch.kernels import sr

            uniforms = sr.uniform(key, tile.shape, x.device, tile.box)
    table = config.table(x.device)
    if config.stochastic_rounding and uniforms is not None:
        codes = mappings.encode_stochastic_uniform(n, table, uniforms)
    elif config.stochastic_rounding and key is not None:
        codes = mappings.encode_stochastic(n, table, key)
    else:
        codes = mappings.encode(n, table)
    del n
    if config.bits == 4:
        codes = packing.pack4(codes)
    return QuantizedTensor(codes, scales, tuple(x.shape), config)


def dequantize(q: QuantizedTensor) -> torch.Tensor:
    """Decompress back to fp32 (N^{-1} ∘ T)."""
    config = q.config
    codes = q.codes
    if config.bits == 4:
        codes = packing.unpack4(codes, q.shape[-1])
    codes = codes.reshape(q.shape)
    vals = mappings.decode(codes, config.table(codes.device))
    tile = _tile_of(vals)
    if tile is not None:  # a mesh tile with the whole leaf's scales
        return vals * _tile_denorm(q.scales, config, tile)
    return vals * _denorm_scale(q.scales, q.shape, config)


def quantized_nbytes(shape: Tuple[int, ...], config: QuantConfig) -> int:
    """Bytes of ``quantize(x, config)`` for a ``shape`` tensor, from shapes
    alone: codes plus fp32 scales."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    if n == 0:
        return 0
    if config.bits == 4:
        last = shape[-1] if shape else 1
        codes = (n // last) * packing.packed_last_dim(last)
    else:
        codes = n
    if config.normalization == "pertensor":
        scales = 1
    elif config.normalization == "blockwise":
        scales = normalization.blockwise_num_blocks(n, config.block_size)
    elif config.normalization == "rank1":
        scales = sum(shape) if len(shape) >= 2 else 1
    else:
        raise ValueError(f"unknown normalization {config.normalization!r}")
    return int(codes + scales * 4)


def state_bytes(x: Any) -> int:
    """Persistent bytes of an optimizer-state leaf (quantized or raw)."""
    if isinstance(x, QuantizedTensor):
        return x.nbytes()
    return int(x.numel() * x.element_size())

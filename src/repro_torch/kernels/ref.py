"""Plain torch versions of the kernels' arithmetic (the oracles).

Port of ``repro/kernels/ref.py``. These are what the CPU path runs and what
``chip_smoke.py`` holds the CUDA kernels against on the card, so they spell
out the kernel's exact fp32 operation order: ``b1*m + (1-b1)*g`` as two
products and one add (no fused multiply-add), IEEE division and square
root, midpoint compare-and-sum encoding. Scalar hyperparameters are Python
floats, rounded to fp32 exactly where the reference rounds them.

The table codecs and nibble packing are ``core.mappings``'/``core.packing``'s
(the reference keeps private copies of the same arithmetic). Unlike the
reference, which vmaps a 2-d oracle over stacked slices, every
function here broadcasts over any leading slice dims: ``w`` is ``(..., R,
C)``, row stats ``(..., R)``, column stats ``(C,)``, SR seeds ``(..., 2)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.mappings import decode as decode_table
from repro_torch.core.mappings import encode as encode_table
from repro_torch.core.mappings import encode_stochastic_uniform as encode_table_stochastic_bits
from repro_torch.core.normalization import _guard
from repro_torch.core.packing import pack4 as pack_codes
from repro_torch.core.packing import unpack4
from repro_torch.kernels.sr import STREAM_M, STREAM_V, threefry2x32, uniform_from_bits

__all__ = [
    "unpack_codes",
    "pack_codes",
    "decode_table",
    "encode_table",
    "encode_table_stochastic_bits",
    "dequant_blockwise",
    "quant_blockwise",
    "dequant_rank1",
    "slice_uniforms",
    "fused_adamw4_reference",
    "fused_adamw4_sr_reference",
]

_BLOCK = 128


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """(..., C/2) uint8 -> (..., C) uint8 codes (low nibble first)."""
    return unpack4(packed, 2 * packed.shape[-1])


def dequant_blockwise(packed: torch.Tensor, scale: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """packed (..., C/2), scale (..., C/128) -> (..., C) fp32."""
    vals = decode_table(unpack_codes(packed), table)
    return vals * torch.repeat_interleave(scale, _BLOCK, dim=-1)


def quant_blockwise(x: torch.Tensor, table: torch.Tensor, block: int = _BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., C) fp32 or bf16, C % block == 0 -> packed (..., C/2) uint8 and
    guarded absmax scales (..., C/block) fp32; round to nearest. The input is
    taken in fp32, as the kernel takes it."""
    *lead, C = x.shape
    blocks = x.to(torch.float32).reshape(*lead, C // block, block)
    scale = _guard(torch.amax(torch.abs(blocks), dim=-1))
    n = (blocks / scale[..., None]).reshape(*lead, C)
    return pack_codes(encode_table(n, table)), scale


def dequant_rank1(packed: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                  table: torch.Tensor) -> torch.Tensor:
    """packed (..., R, C/2), r (..., R), c (C,) -> (..., R, C) fp32."""
    vals = decode_table(unpack_codes(packed), table)
    return vals * _guard(torch.minimum(r[..., :, None], c))


def slice_uniforms(seed: torch.Tensor, shape: Tuple[int, int], stream: int,
                   tile: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Per-element uniforms for stacked (R, C) slices: slice ``l`` is keyed
    by seed row ``seed[l]`` (int64 words), counter = slice-local r*C + c.
    ``tile = (r0, c0, C_glob)``: the (R, C) are rows ``r0...`` and columns
    ``c0...`` of slices ``C_glob`` wide, and the counter is the slice's."""
    R, C = shape
    r0, c0, C_glob = (0, 0, C) if tile is None else tile
    rows = torch.arange(r0, r0 + R, dtype=torch.int64, device=seed.device)
    cols = torch.arange(c0, c0 + C, dtype=torch.int64, device=seed.device)
    linear = rows[:, None] * C_glob + cols[None, :]
    k0 = seed[..., 0, None, None]
    k1 = seed[..., 1, None, None]
    w0, _ = threefry2x32(k0, k1, linear, stream)
    return uniform_from_bits(w0)


def _adamw_core(w, g, m_packed, m_scale, v_packed, v_r, v_c, m_table, v_table,
                lr, b1, b2, eps, weight_decay, bc1, bc2):
    g32 = g.to(torch.float32)
    w32 = w.to(torch.float32)
    m = dequant_blockwise(m_packed, m_scale, m_table)
    v = dequant_rank1(v_packed, v_r, v_c, v_table)
    m_new = b1 * m + (1.0 - b1) * g32
    v_new = b2 * v + (1.0 - b2) * g32 * g32
    u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    w_new = (w32 - lr * (u + weight_decay * w32)).to(w.dtype)
    return w_new, m_new, v_new


def _requant(m_new, v_new, v_r_new, v_c_new, m_table, v_table, u_m=None, u_v=None):
    *lead, R, C = m_new.shape
    blocks = m_new.reshape(*lead, R, C // _BLOCK, _BLOCK)
    m_scale_new = _guard(torch.amax(torch.abs(blocks), dim=-1))
    m_n = (blocks / m_scale_new[..., None]).reshape(m_new.shape)
    if u_m is None:
        m_codes = encode_table(m_n, m_table)
    else:
        m_codes = encode_table_stochastic_bits(m_n, m_table, u_m)
    del m_n
    if v_r_new is None:
        v_r_new = torch.amax(v_new, dim=-1)
    if v_c_new is None:
        v_c_new = torch.amax(v_new, dim=-2)
    v_n = v_new / _guard(torch.minimum(v_r_new[..., :, None], v_c_new))
    if u_v is None:
        v_codes = encode_table(v_n, v_table)
    else:
        v_codes = encode_table_stochastic_bits(v_n, v_table, u_v)
    return pack_codes(m_codes), m_scale_new, pack_codes(v_codes), v_r_new, v_c_new


def fused_adamw4_reference(
    w, g, m_packed, m_scale, v_packed, v_r, v_c, m_table, v_table,
    lr, b1: float, b2: float, eps: float, weight_decay: float, bc1, bc2,
    v_r_new: Optional[torch.Tensor] = None, v_c_new: Optional[torch.Tensor] = None,
):
    """dequant -> AdamW (Eq. 1) -> RTN requant. Returns (w_new, m_packed_new,
    m_scale_new, v_packed_new, v_r_new, v_c_new); new rank-1 stats default
    to the row/col maxes of the updated v (pass them for stacked leaves)."""
    w_new, m_new, v_new = _adamw_core(
        w, g, m_packed, m_scale, v_packed, v_r, v_c, m_table, v_table,
        lr, b1, b2, eps, weight_decay, bc1, bc2,
    )
    return (w_new,) + _requant(m_new, v_new, v_r_new, v_c_new, m_table, v_table)


def fused_adamw4_sr_reference(
    w, g, m_packed, m_scale, v_packed, v_r, v_c, m_table, v_table,
    lr, b1: float, b2: float, eps: float, weight_decay: float, bc1, bc2,
    seed: torch.Tensor,
    v_r_new: Optional[torch.Tensor] = None, v_c_new: Optional[torch.Tensor] = None,
    tile: Optional[Tuple[int, int, int]] = None,
):
    """Stochastic-rounding twin of ``fused_adamw4_reference``: both moments
    requantize with counter-based Threefry uniforms keyed by ``seed``
    ((..., 2) int64 key words, one row per slice) at the slice-local
    counters of ``tile`` (``slice_uniforms``)."""
    w_new, m_new, v_new = _adamw_core(
        w, g, m_packed, m_scale, v_packed, v_r, v_c, m_table, v_table,
        lr, b1, b2, eps, weight_decay, bc1, bc2,
    )
    shape = tuple(w.shape[-2:])
    u_m = slice_uniforms(seed, shape, STREAM_M, tile)
    u_v = slice_uniforms(seed, shape, STREAM_V, tile)
    return (w_new,) + _requant(m_new, v_new, v_r_new, v_c_new, m_table, v_table, u_m, u_v)

"""Threefry-2x32 (20 rounds, Random123 / JAX compatible) and the two draws
that stochastic rounding uses, in plain integer torch ops.

A frozen copy of the arithmetic the optimizer's stochastic rounding is
defined by, kept here so that the benchmark's reference works the noise out
again without the program: on host ints for keys, on int32 tensors (the
words' bits, adds wrapping) for the per-element draws.

Key recipe (JAX's partitionable Threefry):

    PRNGKey(s)        = (s >> 32, s & M)
    fold_in(k, d)     = threefry2x32(k, (0, d))
    split(k, n)[i]    = threefry2x32(k, (0, i))
    jax_uniform(k, n) = bitcast(((w0 ^ w1) >> 9) | 0x3F800000) - 1,
                        (w0, w1) = threefry2x32(k, (0, flat index))
    slice_uniform     = (w0 >> 8) * 2^-24,
                        (w0, _) = threefry2x32(seed row, (r * C + c, stream))

The first draw is the unfused quantizer's; the second, per (R, C) slice, is
the fused update's.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
STREAM_M = 0
STREAM_V = 1

Key = Tuple[int, int]


def threefry2x32(k0, k1, c0, c1):
    """The two output words of Threefry-2x32 for key (k0, k1) and counter
    (c0, c1). On host ints: ints. With a tensor counter: int32 tensors
    holding the words' 32 bits (two's complement), computed in place, the
    adds wrapping mod 2^32 and each right shift masked to a logical one."""
    k0, k1 = k0 & MASK, k1 & MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    if isinstance(c0, torch.Tensor) or isinstance(c1, torch.Tensor):
        return _tensor_rounds(c0, c1, ks)
    x0 = (c0 + k0) & MASK
    x1 = (c1 + k1) & MASK
    for group in range(5):
        rots = _ROT[0:4] if group % 2 == 0 else _ROT[4:8]
        for r in rots:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & MASK
    return x0, x1


def _i32(v: int) -> int:
    """The signed 32-bit value of a 32-bit word."""
    v &= MASK
    return v - (1 << 32) if v >= 1 << 31 else v


def _word(c, k: int, like: torch.Tensor) -> torch.Tensor:
    """``(c + k) mod 2^32`` as an int32 tensor shaped like ``like``."""
    if isinstance(c, torch.Tensor) and c.dtype == torch.int32:
        x = c.clone()
    else:
        x = torch.as_tensor(c, dtype=torch.int64, device=like.device) & MASK
        x = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
    return x.expand(like.shape).contiguous().add_(_i32(k))


def _tensor_rounds(c0, c1, ks):
    like = torch.broadcast_tensors(*(c for c in (c0, c1) if isinstance(c, torch.Tensor)))[0]
    x0, x1 = _word(c0, ks[0], like), _word(c1, ks[1], like)
    t = torch.empty_like(x0)
    for group in range(5):
        rots = _ROT[0:4] if group % 2 == 0 else _ROT[4:8]
        for r in rots:
            x0.add_(x1)
            torch.bitwise_left_shift(x1, r, out=t)
            x1.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1)
            x1.bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(_i32(ks[(group + 1) % 3]))
        x1.add_(_i32(ks[(group + 2) % 3] + group + 1))
    return x0, x1


def prng_key(seed: int) -> Key:
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return ((seed >> 32) & MASK, seed & MASK)


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def split(key: Key, num: int) -> Tuple[Key, ...]:
    return tuple(threefry2x32(key[0], key[1], 0, i) for i in range(num))


def jax_uniform(key: Key, start: int, count: int, device) -> torch.Tensor:
    """Elements ``[start, start + count)`` of the flat fp32 draw in [0, 1)
    that ``key`` gives a tensor of at least that many elements."""
    idx = torch.arange(start, start + count, dtype=torch.int64, device=device)
    w0, w1 = threefry2x32(key[0], key[1], 0, idx)
    bits = (w0.bitwise_xor_(w1).bitwise_right_shift_(9).bitwise_and_(0x7FFFFF)
            .bitwise_or_(0x3F800000))
    return torch.clamp_min(bits.view(torch.float32) - 1.0, 0.0)


def slice_uniform(seed: Key, r0: int, rows: int, C: int, stream: int,
                  device) -> torch.Tensor:
    """Rows ``[r0, r0 + rows)`` of an (R, C) slice's draw for ``stream``."""
    lin = (torch.arange(r0, r0 + rows, dtype=torch.int64, device=device)[:, None] * C
           + torch.arange(C, dtype=torch.int64, device=device)[None, :])
    w0, _ = threefry2x32(seed[0], seed[1], lin, stream)
    return w0.bitwise_right_shift_(8).bitwise_and_(0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))

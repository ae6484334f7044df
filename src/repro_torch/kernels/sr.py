"""Counter-based randomness for stochastic rounding, JAX-compatible.

Port of ``repro/kernels/sr.py``. ``threefry2x32`` is Threefry-2x32 (20
rounds, Random123/JAX-compatible). Torch on the CPU has no uint32 add or
shift, so every word lives in an int64 (a tensor or a Python int) and is
masked with ``& 0xFFFFFFFF`` after each add and shift; the same code then
runs on host ints, CPU tensors and CUDA tensors.

A key is a host-side pair of Python ints ``(k0, k1)``: deriving keys costs
no device work and no synchronisation. The key recipe below reproduces JAX
0.9's partitionable Threefry bit for bit (``jax_threefry_partitionable`` is
on by default there):

    PRNGKey(s)       = (s >> 32, s & M)
    fold_in(k, d)    = threefry2x32(k, (0, d))              (both words)
    split(k, n)[i]   = threefry2x32(k, (0, i))
    bits(k, shape)   = w0 ^ w1 of threefry2x32(k, (0, i)),  i = flat index
    uniform(k, shape)= bitcast((bits >> 9) | 0x3F800000) - 1

The fused kernel's own draw is ``element_uniforms``: counter0 = slice-local
``r * C + c``, counter1 = the stream id, uniform = ``(w0 >> 8) * 2^-24``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "threefry2x32",
    "uniform_from_bits",
    "element_uniforms",
    "tensor_uniforms",
    "flat_indices",
    "PRNGKey",
    "fold_in",
    "split",
    "bits",
    "uniform",
    "STREAM_M",
    "STREAM_V",
    "STREAM_GRAD",
    "STREAM_SAMPLE",
]

# Stream ids separating noise within one (key, element) pair.
STREAM_M = 0
STREAM_V = 1
STREAM_GRAD = 2
STREAM_SAMPLE = 3

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # Threefry key-schedule parity constant
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)

Key = Tuple[int, int]
Box = Tuple[Tuple[int, int], ...]


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 over 32-bit words held in int64 tensors or Python ints
    (standard broadcasting). Returns the two output words."""
    k0 = k0 & MASK
    k1 = k1 & MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + k0) & MASK
    x1 = (c1 + k1) & MASK
    if isinstance(x0, torch.Tensor) or isinstance(x1, torch.Tensor):
        return _tensor_rounds(x0, x1, ks)
    for group in range(5):
        rots = _ROT[0:4] if group % 2 == 0 else _ROT[4:8]
        for r in rots:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & MASK
    return x0, x1


def _tensor_rounds(x0, x1, ks):
    """The 20 rounds of ``threefry2x32`` on tensors: the same integer ops,
    in place on two fresh words and one scratch word (an out-of-place round
    allocates seven temporaries of the words' size)."""
    like = x0 if isinstance(x0, torch.Tensor) else x1
    x0, x1 = (torch.as_tensor(x, dtype=torch.int64, device=like.device) for x in (x0, x1))
    x0, x1 = (x.clone(memory_format=torch.contiguous_format)
              for x in torch.broadcast_tensors(x0, x1))
    t = torch.empty_like(x0)
    for group in range(5):
        rots = _ROT[0:4] if group % 2 == 0 else _ROT[4:8]
        for r in rots:
            x0.add_(x1).bitwise_and_(MASK)
            torch.bitwise_left_shift(x1, r, out=t).bitwise_and_(MASK)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(group + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(group + 2) % 3] + group + 1).bitwise_and_(MASK)
    return x0, x1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words -> fp32 uniform in [0, 1) from the top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def element_uniforms(k0: int, k1: int, shape: Tuple[int, int], stream: int,
                     device) -> torch.Tensor:
    """Per-element uniforms for a 2-d (R, C) slice, counter = r * C + c — the
    plain twin of the fused kernel's in-register draw."""
    R, C = shape
    linear = torch.arange(R * C, dtype=torch.int64, device=device).reshape(R, C)
    w0, _ = threefry2x32(k0, k1, linear, stream)
    return uniform_from_bits(w0)


def flat_indices(shape, box: Optional[Box], device) -> torch.Tensor:
    """int64 flat (row-major) indices in ``shape`` of the elements of
    ``box`` (``(start, stop)`` per dim; ``None`` is the whole tensor),
    shaped like the box."""
    shape = tuple(int(d) for d in shape)
    if box is None:
        n = 1
        for d in shape:
            n *= d
        return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in range(len(shape) - 1, -1, -1):
        a, b = box[d]
        r = torch.arange(a, b, dtype=torch.int64, device=device) * stride
        idx = r.reshape((-1,) + (1,) * (len(shape) - 1 - d)) + idx
        stride *= shape[d]
    return idx.reshape(tuple(b - a for a, b in box))


def tensor_uniforms(key: Key, shape, stream: int, device, box: Optional[Box] = None
                    ) -> torch.Tensor:
    """Per-element uniforms for any rank, counter = flat global index (of
    the elements of ``box`` in a ``shape`` tensor, when given)."""
    w0, _ = threefry2x32(key[0], key[1], flat_indices(shape, box, device), stream)
    return uniform_from_bits(w0)


# ---------------------------------------------------------------------------
# JAX-compatible key stream
# ---------------------------------------------------------------------------


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` as a host key pair."""
    seed = int(seed)
    if seed < 0:
        seed &= 0xFFFFFFFFFFFFFFFF
    return ((seed >> 32) & MASK, seed & MASK)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` (data taken as uint32)."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)`` as a tuple of key pairs."""
    return tuple(threefry2x32(key[0], key[1], 0, i) for i in range(num))


def bits(key: Key, shape, device, box: Optional[Box] = None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words, held in int64); with
    ``box``, only the words of its elements."""
    n = 1
    for d in shape:
        n *= int(d)
    if n >= 1 << 32:
        raise ValueError("bits(): more than 2^32 draws need the high counter word")
    w0, w1 = threefry2x32(key[0], key[1], 0, flat_indices(shape, box, device))
    return w0 ^ w1


def uniform(key: Key, shape, device, box: Optional[Box] = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (fp32 in [0, 1)), bit for bit;
    with ``box``, its elements of that draw."""
    b = bits(key, shape, device, box)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0)

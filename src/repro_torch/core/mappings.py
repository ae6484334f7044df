"""Quantization mappings T: code -> [0,1] (or [-1,1] signed), as a registry.

Port of ``repro/core/mappings.py``. The numpy table functions are copied, so
every table is bit-identical to the reference for each name x bits x
signedness; the codecs are torch. Encoding is round-to-nearest by midpoint
comparison (ties to the lower code) with a stochastic-rounding variant
(App. E.3) that draws its uniforms from the JAX-compatible key stream of
``repro_torch.kernels.sr``.
"""

from __future__ import annotations

import dataclasses
import difflib
import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

__all__ = [
    "MappingSpec",
    "register_mapping",
    "registered",
    "get_spec",
    "mapping_table",
    "encode",
    "decode",
    "encode_stochastic",
    "encode_stochastic_uniform",
]


@dataclasses.dataclass(frozen=True)
class MappingSpec:
    """A registered quantization map: ``table_fn(bits, signed)`` returns the
    sorted, unique table as a float numpy array of length <= 2^bits."""

    name: str
    table_fn: Callable[[int, bool], np.ndarray]
    display: str
    statistic: str = ""
    zero_code: str = ""
    symmetric_signed: bool = True
    reference: str = ""


_REGISTRY: Dict[str, MappingSpec] = {}


def register_mapping(
    name: str,
    table_fn: Callable[[int, bool], np.ndarray],
    *,
    display: str = "",
    statistic: str = "",
    zero_code: str = "",
    symmetric_signed: bool = True,
    reference: str = "",
) -> MappingSpec:
    """Register a quantization map — the only way a map becomes usable in a
    ``QuantConfig``."""
    if not isinstance(name, str) or not name:
        raise ValueError(f"mapping name must be a non-empty string, got {name!r}")
    if name in _REGISTRY:
        raise ValueError(f"mapping {name!r} is already registered")
    spec = MappingSpec(
        name=name,
        table_fn=table_fn,
        display=display or name,
        statistic=statistic,
        zero_code=zero_code,
        symmetric_signed=symmetric_signed,
        reference=reference,
    )
    _REGISTRY[name] = spec
    return spec


def registered() -> Tuple[str, ...]:
    """Names of all registered maps, in registration order."""
    return tuple(_REGISTRY)


def get_spec(name: str) -> MappingSpec:
    """Resolve a mapping name, with a did-you-mean on typos."""
    spec = _REGISTRY.get(name)
    if spec is None:
        hint = ""
        close = difflib.get_close_matches(str(name), _REGISTRY, n=1)
        if close:
            hint = f" — did you mean {close[0]!r}?"
        raise ValueError(
            f"unknown mapping {name!r}; registered mappings: {registered()}"
            f"{hint} (add new maps with repro_torch.core.mappings.register_mapping)"
        )
    return spec


# ---------------------------------------------------------------------------
# table functions (numpy, copied from the reference so tables are bit-equal)
# ---------------------------------------------------------------------------


def _de_fraction_levels(F: int) -> np.ndarray:
    """Midpoint fraction levels for F fraction bits, distributed in (0.1, 1)."""
    j = np.arange(2**F + 1, dtype=np.float64)
    p = (1.0 - 0.1) / (2**F) * j + 0.1
    return (p[:-1] + p[1:]) / 2.0


def _de_unsigned_values(width: int, special_one: bool = True) -> np.ndarray:
    """All dynamic-exponent values for ``width``-bit unsigned codes (code 0 ->
    0.0, and code 1 -> 1.0 if ``special_one``; else 10^-E * fraction[F])."""
    values = np.zeros(2**width, dtype=np.float64)
    values[0] = 0.0
    start = 1
    if special_one:
        values[1] = 1.0
        start = 2
    for code in range(start, 2**width):
        bits = format(code, f"0{width}b")
        E = len(bits) - len(bits.lstrip("0"))  # leading zeros
        frac_bits = bits[E + 1 :]
        F = len(frac_bits)
        k = int(frac_bits, 2) if F > 0 else 0
        frac = _de_fraction_levels(F)[k]
        values[code] = (10.0**-E) * frac
    return values


def _linear_table(bits: int, signed: bool) -> np.ndarray:
    if signed:
        half = (np.arange(2 ** (bits - 1), dtype=np.float64) + 1) / 2 ** (bits - 1)
        return np.concatenate([-half[::-1], half])
    return (np.arange(2**bits, dtype=np.float64) + 1) / 2**bits


def _de_table(bits: int, signed: bool) -> np.ndarray:
    if signed:
        mag = _de_unsigned_values(bits - 1, special_one=False)
        # the (sign=1, magnitude=0) pattern is repurposed as +1.0 (App. E.2)
        vals = np.concatenate([mag, np.array([1.0]), -mag[1:]])
    else:
        vals = _de_unsigned_values(bits)
    return np.sort(np.unique(vals))


def _de0_table(bits: int, signed: bool) -> np.ndarray:
    vals = _de_table(bits, signed)
    return vals[vals != 0.0]


def _dynamic_table(bits: int, signed: bool) -> np.ndarray:
    if signed:
        mag = _de_unsigned_values(bits - 1, special_one=True)
        return np.sort(np.unique(np.concatenate([-mag, mag])))
    return np.sort(np.unique(_de_unsigned_values(bits)))


def _quantile_table(bits: int, signed: bool) -> np.ndarray:
    from statistics import NormalDist

    inv_cdf = NormalDist().inv_cdf
    P = 0.995  # clip the unbounded normal tails at the 99.5th percentile
    if signed:
        K = 2 ** (bits - 1) - 1
        pos = np.array(
            [inv_cdf(0.5 + 0.5 * P * (i + 1) / K) for i in range(K)], np.float64
        )
        pos /= pos[-1]
        return np.concatenate([-pos[::-1], [0.0], pos])
    K = 2**bits
    vals = np.array(
        [inv_cdf(0.5 + 0.5 * P * (i + 1) / K) for i in range(K)], np.float64
    )
    return vals / vals[-1]


def _log_ema_table(bits: int, signed: bool) -> np.ndarray:
    decades = float(bits)
    if signed:
        K = 2 ** (bits - 1) - 1
        pos = 10.0 ** (-decades * (1.0 - (np.arange(K, dtype=np.float64) + 1.0) / K))
        return np.concatenate([-pos[::-1], [0.0], pos])
    K = 2**bits
    return 10.0 ** (-decades * (1.0 - (np.arange(K, dtype=np.float64) + 1.0) / K))


# ---------------------------------------------------------------------------
# table materialization + codecs
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mapping_table_np(kind: str, bits: int, signed: bool) -> np.ndarray:
    """Sorted fp32 numpy table for (kind, bits, signed), contract-checked."""
    spec = get_spec(kind)
    if bits < 2 or bits > 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    vals = np.asarray(spec.table_fn(bits, signed), dtype=np.float64).astype(np.float32)
    if vals.ndim != 1 or vals.size == 0 or vals.size > 2**bits:
        raise ValueError(
            f"mapping {kind!r}: table must be 1-d with 1..2^{bits} entries, "
            f"got shape {vals.shape}"
        )
    if not np.all(np.isfinite(vals)):
        raise ValueError(f"mapping {kind!r}: table contains non-finite values")
    if not np.all(np.diff(vals) > 0):
        raise ValueError(f"mapping {kind!r}: table must be strictly increasing")
    vals.setflags(write=False)
    return vals


@functools.lru_cache(maxsize=None)
def _mapping_table_on(kind: str, bits: int, signed: bool, device: str) -> torch.Tensor:
    return torch.from_numpy(_mapping_table_np(kind, bits, signed).copy()).to(device)


def mapping_table(kind: str, bits: int, signed: bool, device) -> torch.Tensor:
    """The sorted fp32 quantization-point table on ``device`` (cached; treat
    the returned tensor as read-only)."""
    return _mapping_table_on(kind, bits, signed, str(torch.device(device)))


def encode(n: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest code indices: idx = sum_k [n > midpoint_k] (ties go
    to the lower code). One pass per midpoint keeps the transient at one
    byte per element."""
    mids = (table[1:] + table[:-1]) / 2.0
    idx = torch.zeros(n.shape, dtype=torch.uint8, device=n.device)
    for k in range(mids.shape[0]):
        idx += n > mids[k]
    return idx


def decode(codes: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Dequantize code indices back to fp32 quantization points."""
    return table[codes.long()]


def encode_stochastic(n: torch.Tensor, table: torch.Tensor, key) -> torch.Tensor:
    """Stochastic rounding with ``jax.random.uniform``'s draw for ``key``
    (reproduced bit for bit by ``sr.uniform``)."""
    from repro_torch.kernels import sr

    return encode_stochastic_uniform(n, table, sr.uniform(key, n.shape, n.device))


def encode_stochastic_uniform(
    n: torch.Tensor, table: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """Round to the bracketing codes with probability proportional to
    proximity, deciding with uniforms ``u`` in [0, 1); values outside the
    table clamp."""
    k = table.shape[0]
    ge = torch.zeros(n.shape, dtype=torch.int64, device=n.device)
    for j in range(k):
        ge += n >= table[j]
    lo = torch.clamp(ge - 1, 0, k - 2)
    t_lo = table[lo]
    t_hi = table[lo + 1]
    span = torch.clamp_min(t_hi - t_lo, 1e-12)
    p_hi = torch.clamp((n - t_lo) / span, 0.0, 1.0)
    idx = lo + (u < p_hi)
    return idx.to(torch.uint8)


register_mapping(
    "linear",
    _linear_table,
    display="Linear",
    statistic="second moment (EMA of squared grads)",
    zero_code="zero excluded by construction (both signednesses)",
    symmetric_signed=True,
    reference="4-bit Optimizers App. E.2",
)
register_mapping(
    "de",
    _de_table,
    display="DE",
    statistic="first moment / signed zero-clustered tensors",
    zero_code="unsigned has 0.0; signed repurposes -0 as +1.0 (asymmetric)",
    symmetric_signed=False,
    reference="Dettmers 2015; 4-bit Optimizers App. E.2",
)
register_mapping(
    "de0",
    _de0_table,
    display="DE-0",
    statistic="second moment (zero-point fix)",
    zero_code="zero code removed from DE (2^b - 1 points)",
    symmetric_signed=False,
    reference="4-bit Optimizers App. E.2 (DE-0)",
)
register_mapping(
    "dynamic",
    _dynamic_table,
    display="Dyn",
    statistic="signed matrix factors (Shampoo Kronecker blocks)",
    zero_code="zero representable; signed exactly odd symmetric with ±1.0",
    symmetric_signed=True,
    reference="bitsandbytes create_dynamic_map; 4-bit Shampoo",
)
register_mapping(
    "quantile",
    _quantile_table,
    display="Qtl",
    statistic="normally distributed moments / weights",
    zero_code="signed has a zero code; unsigned strictly positive",
    symmetric_signed=True,
    reference="bitsandbytes quantile quantization; QLoRA NF4",
)
register_mapping(
    "log-ema",
    _log_ema_table,
    display="LogEMA",
    statistic="EMA statistics spanning decades (second moment)",
    zero_code="unsigned zero-excluding; signed symmetric with a zero code",
    symmetric_signed=True,
    reference="SOLO (logarithmic quantization for EMA dynamics)",
)

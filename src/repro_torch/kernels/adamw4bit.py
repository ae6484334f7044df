"""Fused 4-bit AdamW update in two passes: the CUDA kernels' wrappers and
their plain versions.

Port of ``repro/kernels/adamw4bit.py::fused_adamw4`` and of the rank-1
stats prepass before it in ``repro/kernels/ops.py::fused_adamw4_leaf``. Both
kernels live in ``repro_torch/csrc/fused_adamw4.cu``, built with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface on first
use and loaded with ``ctypes`` (``kernels.build``); the source says what
bounds each pass and how it is laid out.

``rank1_new_stats`` (pass 1) computes the per-dim maxima of the updated
second moment ``b2 * v + (1 - b2) * g * g`` of a leaf without writing that
fp32 tensor anywhere; ``fused_adamw4`` (pass 2) takes a stacked ``(L, R,
C)`` leaf (or ``(R, C)``, L == 1) and runs ONE launch over every slice. A
CUDA tensor launches the kernel and adds one to ``LAUNCHES[<name>]``; a CPU
tensor takes the plain version (``rank1_new_stats_plain``, the reference's
prepass in torch ops; ``fused_adamw4_plain``, the oracles of ``ref.py``);
while a count listens (``LISTENERS`` is not empty: the roofline counts a
step on ``meta``), a ``meta`` tensor gets outputs of the right shapes and
no values; anything else raises. There is no fallback from a kernel. Each
pass that launches, or stands in for a launch on ``meta``, tells every
callable in ``LISTENERS`` its name and ``(L, R, C)``: a dispatch mode
cannot see a kernel's memory traffic, so ``roofline.measured`` adds its
byte model there.

Unlike the functional reference, the param is updated in place when
``out`` is the param itself (the optimizer does this to save a copy of
every fused leaf); codes and scales are fresh tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

__all__ = [
    "fused_adamw4",
    "fused_adamw4_plain",
    "rank1_new_stats",
    "rank1_new_stats_plain",
    "hyper_scalars",
    "LAUNCHES",
    "LISTENERS",
    "SOURCE",
]

_BLOCK = 128
SOURCE = build.CSRC / "fused_adamw4.cu"

# Kernel launches by wrapper name; only a real CUDA launch counts.
LAUNCHES: Dict[str, int] = {"fused_adamw4": 0, "rank1_new_stats": 0}
# told (pass name, (L, R, C)) at each pass on the card or on ``meta``
LISTENERS: List[Callable[[str, Tuple[int, int, int]], None]] = []


def _heard(name: str, dims: Tuple[int, int, int]) -> None:
    for listener in LISTENERS:
        listener(name, dims)


def _runs_on(dev: torch.device) -> bool:
    """Whether a pass runs on ``dev``: the card, or ``meta`` while a count
    listens."""
    return dev.type == "cuda" or (dev.type == "meta" and bool(LISTENERS))

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE)
        fn = lib.fused_adamw4_launch
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [
            p, p, i, p,             # w, w_out, w_is_bf16, g
            p, p, p,                # m_codes, m_scale, v_codes
            p, p, p, p,             # vr, vc, vr_new, vc_new
            p, i,                   # seeds, use_sr
            p, p, p,                # m_codes_out, m_scale_out, v_codes_out
            ll, ll, ll,             # L, R, C
            ll, ll, ll,             # r0, c0, C_glob (the tile's place)
            p, p, i,                # m_table, m_mid, m_points (host)
            p, p, i,                # v_table, v_mid, v_points (host)
            f, f, f, f, f, f, f, f, f,  # lr b1 omb1 b2 omb2 eps wd bc1 bc2
            p,                      # stream
        ]
        fn.restype = ctypes.c_int
        fn = lib.rank1_stats_launch
        fn.argtypes = [
            p, p, p, p,             # v_codes, vr, vc, g
            p, p,                   # row_max, col_max
            ll, ll, ll,             # L, R, C
            p, i, f, f,             # v_table (host), v_points, b2, omb2
            p,                      # stream
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def hyper_scalars(b1: float, b2: float, eps: float, weight_decay: float) -> Dict[str, float]:
    """The fp32 values the reference's arithmetic uses for the Python-float
    hyperparameters: ``b1 * m`` rounds b1 to fp32, ``(1.0 - b1) * g`` rounds
    the double difference to fp32."""
    f = lambda x: float(np.float32(x))
    return dict(b1=f(b1), omb1=f(1.0 - b1), b2=f(b2), omb2=f(1.0 - b2),
                eps=f(eps), wd=f(weight_decay))


def _as3(x: torch.Tensor, L: int, last: int) -> torch.Tensor:
    return x.reshape(L, -1, last)


def _leaf_dims(shape: Tuple[int, ...]) -> Tuple[int, int, int]:
    R, C = shape[-2], shape[-1]
    return math.prod(shape) // (R * C), R, C


def rank1_new_stats_plain(v_packed, v_r, v_c, g, v_table, b2: float, shape):
    """The plain version of the stats pass: the per-dim maxima of
    ``b2 * v + ((1 - b2) * g) * g`` (every op rounded in fp32, as the kernel
    rounds it) over a leaf of ``shape``, ``rank1_normalize``'s layout. It
    writes the fp32 v_new of the whole leaf: the reference's eager form,
    kept as the oracle and for the CPU, where memory is not the limit."""
    v_new = ref.dequant_rank1(v_packed, v_r, v_c, v_table.to(g.device))
    t = g * (1.0 - b2)
    t.mul_(g)
    v_new.mul_(b2).add_(t)
    del t
    v_new = v_new.reshape(shape)
    nd = len(shape)
    return tuple(
        torch.amax(v_new, dim=tuple(i for i in range(nd) if i != r)) for r in range(nd)
    )


def _dim_stats(row_max: torch.Tensor, col_max: torch.Tensor, shape) -> Tuple[torch.Tensor, ...]:
    """Per-dim maxima of a leaf from its (L, R) row and (C,) column maxima:
    every dim but the last is a max over the rows."""
    rows = row_max.reshape(*shape[:-1])
    nd = rows.ndim
    stats = []
    for r in range(nd):
        dims = tuple(i for i in range(nd) if i != r)
        stats.append(torch.amax(rows, dim=dims) if dims else rows)
    return tuple(stats) + (col_max,)


def rank1_new_stats(
    v_packed: torch.Tensor,   # (L, R, C/2) uint8
    v_r: torch.Tensor,        # (L, R) old per-slice row stats
    v_c: torch.Tensor,        # (C,) old col stats (shared)
    g: torch.Tensor,          # (L, R, C) fp32
    v_table: torch.Tensor,    # (<=16,) unsigned linear table (any device; CPU is free)
    b2: float,
    shape: Tuple[int, ...],   # the leaf's own shape, L*R*C elements
) -> Tuple[torch.Tensor, ...]:
    """Pass 1: the rank-1 stats of the updated v, one array per dim of
    ``shape``. On the card the kernel reduces to (L, R) row and (C,) column
    maxima in one launch; no fp32 tensor of the leaf's size is written."""
    L, R, C = _leaf_dims(tuple(shape))
    dev = g.device
    if dev.type == "cpu":
        return rank1_new_stats_plain(v_packed, v_r, v_c, g, v_table, b2, shape)
    if not _runs_on(dev):
        raise ValueError(f"rank1_new_stats: unsupported device {dev}")
    if C % _BLOCK:
        raise ValueError(f"rank1_new_stats: C={C} must be a multiple of {_BLOCK}")
    check = lambda what, x, dtype, shp: build.check_operand("rank1_new_stats", what, x, dtype,
                                                            shp, dev)
    check("v_packed", v_packed, torch.uint8, (L, R, C // 2))
    check("v_r", v_r, torch.float32, (L, R))
    check("v_c", v_c, torch.float32, (C,))
    check("g", g, torch.float32, (L, R, C))
    row = torch.empty((L, R), dtype=torch.float32, device=dev)
    col = torch.zeros((C,), dtype=torch.int32, device=dev)  # float bits, merged by atomicMax
    if dev.type == "cuda":
        vt, _, vp = build.host_table(v_table)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())
        err = _library().rank1_stats_launch(
            ptr(v_packed), ptr(v_r), ptr(v_c), ptr(g), ptr(row), ptr(col), L, R, C,
            vt.ctypes.data_as(ctypes.c_void_p), vp,
            float(np.float32(b2)), float(np.float32(1.0 - b2)),  # as the plain version rounds them
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
        if err != 0:
            raise RuntimeError(f"rank1_new_stats: kernel launch failed (cudaError {err})")
        LAUNCHES["rank1_new_stats"] += 1
    _heard("rank1_new_stats", (L, R, C))
    return _dim_stats(row, col.view(torch.float32), tuple(shape))


def fused_adamw4_plain(w, g, m_packed, m_scale, v_packed, v_r, v_c, v_r_new, v_c_new,
                       m_table, v_table, lr, bc1, bc2, sr_seed=None, *,
                       b1, b2, eps, weight_decay, use_sr=False, tile=None):
    """The plain torch version on (L, R, C) operands; returns (w_new,
    m_packed_new, m_scale_new, v_packed_new). Scalars become 0-d tensors on
    the operands' device so every division is a true IEEE division.
    ``tile = (r0, c0, C_glob)`` places the operands in their slices (the SR
    counters)."""
    dev = w.device
    t = lambda x: torch.full((), float(x), dtype=torch.float32, device=dev)
    m_table, v_table = m_table.to(dev), v_table.to(dev)
    if sr_seed is not None:
        sr_seed = sr_seed.to(dev)
    args = (w, g, m_packed, m_scale, v_packed, v_r, v_c, m_table, v_table,
            t(lr), b1, b2, eps, weight_decay, t(bc1), t(bc2))
    if use_sr:
        out = ref.fused_adamw4_sr_reference(*args, sr_seed, v_r_new, v_c_new, tile=tile)
    else:
        out = ref.fused_adamw4_reference(*args, v_r_new, v_c_new)
    return out[:4]


def fused_adamw4(
    w: torch.Tensor,          # (L, R, C) or (R, C), fp32 or bf16
    g: torch.Tensor,          # like w, fp32
    m_packed: torch.Tensor,   # (L, R, C/2) uint8
    m_scale: torch.Tensor,    # (L, R, C/128) fp32
    v_packed: torch.Tensor,   # (L, R, C/2) uint8
    v_r: torch.Tensor,        # (L, R) old per-slice rank-1 row stats
    v_c: torch.Tensor,        # (C,) old col stats (shared)
    v_r_new: torch.Tensor,    # (L, R) stats of the updated v
    v_c_new: torch.Tensor,    # (C,)
    m_table: torch.Tensor,    # (<=16,) signed DE table (any device; CPU is free)
    v_table: torch.Tensor,    # (<=16,) unsigned linear table
    lr: float,
    bc1: float,               # 1 - b1^t (fp32 value)
    bc2: float,               # 1 - b2^t
    sr_seed: Optional[torch.Tensor] = None,  # (L, 2) key words, int64 values
    *,
    b1: float,
    b2: float,
    eps: float,
    weight_decay: float,
    use_sr: bool = False,
    out: Optional[torch.Tensor] = None,
    tile: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused AdamW step over all stacked slices in ONE launch.

    Returns (w_new, m_packed_new, m_scale_new, v_packed_new) in the input
    rank. ``out`` (shaped like ``w``) receives the param, and may be ``w``.
    ``tile = (r0, c0, C_glob)``: the operands are rows ``[r0, r0 + R)`` and
    columns ``[c0, c0 + C)`` of slices ``C_glob`` wide (``c0 % 128 == 0``);
    the SR noise is then the whole leaf's at those elements. ``None`` is a
    whole leaf, ``(0, 0, C)``.
    """
    squeeze = w.ndim == 2
    if squeeze:
        (R, C), L = w.shape, 1
    else:
        L, R, C = w.shape
    if C % _BLOCK:
        raise ValueError(f"fused_adamw4: C={C} must be a multiple of {_BLOCK}")
    tile = (0, 0, C) if tile is None else tuple(int(t) for t in tile)
    r0, c0, C_glob = tile
    if r0 < 0 or c0 < 0 or c0 % _BLOCK or c0 + C > C_glob or (r0 + R) * C_glob > 1 << 32:
        raise ValueError(f"fused_adamw4: tile {tile} does not place ({R}, {C}) in its slices")
    if use_sr and sr_seed is None:
        raise ValueError("fused_adamw4(use_sr=True) requires sr_seed")
    w3 = w.reshape(L, R, C)
    shapes = dict(
        g=(L, R, C), m_packed=(L, R, C // 2), m_scale=(L, R, C // _BLOCK),
        v_packed=(L, R, C // 2), v_r=(L, R), v_r_new=(L, R),
    )
    ops = dict(
        g=g.reshape(L, R, C), m_packed=_as3(m_packed, L, C // 2),
        m_scale=_as3(m_scale, L, C // _BLOCK), v_packed=_as3(v_packed, L, C // 2),
        v_r=v_r.reshape(L, R), v_r_new=v_r_new.reshape(L, R),
    )
    dev = w.device
    if dev.type == "cpu":
        res = fused_adamw4_plain(
            w3, ops["g"], ops["m_packed"], ops["m_scale"], ops["v_packed"],
            ops["v_r"], v_c, ops["v_r_new"], v_c_new, m_table, v_table, lr, bc1, bc2,
            None if sr_seed is None else sr_seed.reshape(L, 2),
            b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, use_sr=use_sr, tile=tile,
        )
        w_new = res[0]
        if out is not None:
            out.reshape(L, R, C).copy_(w_new)
            w_new = out
        res = (w_new.reshape(L, R, C),) + tuple(res[1:])
    elif _runs_on(dev):
        res = _launch(w3, ops, v_c, v_c_new, m_table, v_table, lr, bc1, bc2, sr_seed,
                      L, R, C, b1, b2, eps, weight_decay, use_sr, out, shapes, tile)
    else:
        raise ValueError(f"fused_adamw4: unsupported device {dev}")
    if squeeze:
        res = tuple(o.reshape(o.shape[1:]) for o in res)
    return res


def _check(what, x, dtype, shape, dev):
    build.check_operand("fused_adamw4", what, x, dtype, shape, dev)


def _launch(w3, ops, v_c, v_c_new, m_table, v_table, lr, bc1, bc2, sr_seed,
            L, R, C, b1, b2, eps, weight_decay, use_sr, out, shapes, tile):
    dev = w3.device
    if w3.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_adamw4: param dtype {w3.dtype} (fp32 or bf16 only)")
    _check("w", w3, w3.dtype, (L, R, C), dev)
    for name, dtype in (("g", torch.float32), ("m_packed", torch.uint8),
                        ("m_scale", torch.float32), ("v_packed", torch.uint8),
                        ("v_r", torch.float32), ("v_r_new", torch.float32)):
        _check(name, ops[name], dtype, shapes[name], dev)
    _check("v_c", v_c, torch.float32, (C,), dev)
    _check("v_c_new", v_c_new, torch.float32, (C,), dev)
    w_out = torch.empty_like(w3) if out is None else out.reshape(L, R, C)
    _check("out", w_out, w3.dtype, (L, R, C), dev)
    seeds = None
    if use_sr:
        s = sr_seed.reshape(L, 2).to(torch.int64)
        s = torch.where(s >= 2**31, s - 2**32, s).to(torch.int32).contiguous()
        # host seed rows go up through pinned memory: no stream synchronisation
        host = s.device.type == "cpu"
        seeds = (s.to(dev) if dev.type == "meta" else s.pin_memory().to(dev, non_blocking=True)
                 ) if host else s
    m_out = torch.empty((L, R, C // 2), dtype=torch.uint8, device=dev)
    ms_out = torch.empty((L, R, C // _BLOCK), dtype=torch.float32, device=dev)
    v_out = torch.empty((L, R, C // 2), dtype=torch.uint8, device=dev)

    if dev.type == "meta":  # shapes only: no values, no launch
        _heard("fused_adamw4", (L, R, C))
        return w_out, m_out, ms_out, v_out
    mt, mmid, mp = build.host_table(m_table)
    vt, vmid, vp = build.host_table(v_table)
    hs = hyper_scalars(b1, b2, eps, weight_decay)
    fp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = _library().fused_adamw4_launch(
        ptr(w3), ptr(w_out), int(w3.dtype == torch.bfloat16), ptr(ops["g"]),
        ptr(ops["m_packed"]), ptr(ops["m_scale"]), ptr(ops["v_packed"]),
        ptr(ops["v_r"]), ptr(v_c), ptr(ops["v_r_new"]), ptr(v_c_new),
        ptr(seeds) if seeds is not None else None, int(use_sr),
        ptr(m_out), ptr(ms_out), ptr(v_out),
        L, R, C, *tile,
        fp(mt), fp(mmid), mp, fp(vt), fp(vmid), vp,
        float(np.float32(lr)), hs["b1"], hs["omb1"], hs["b2"], hs["omb2"],
        hs["eps"], hs["wd"], float(np.float32(bc1)), float(np.float32(bc2)),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"fused_adamw4: kernel launch failed (cudaError {err})")
    LAUNCHES["fused_adamw4"] += 1
    _heard("fused_adamw4", (L, R, C))
    return w_out, m_out, ms_out, v_out

"""Composable gradient transformations with the one compressed-state wrapper
of Alg. 1 — port of ``repro/core/optimizers/transform.py``: ``scale_by_adam``
(with factored second moments), ``trace``, ``scale_by_sm3``,
``scale_by_factored_rms``, ``scale_by_shampoo``, weight decay, the learning
rate, ``compressed``, ``partition`` and ``chain``.

Trees are ordered ``{path: tensor}`` mappings in the reference's leaf order.
A ``GradientTransformation`` is an ``(init, update)`` pair over updates:
``update(updates, state, params=None, *, key=None) -> (updates, state)``.
Keys are host ``(k0, k1)`` pairs from ``repro_torch.kernels.sr``; step
counts are host-side int32 tensors, so learning rates and bias corrections
are host fp32 values and reading them never waits for the device.

Differences from the functional reference, all for memory on the card:
``compressed()`` runs the inner rule one leaf at a time (decompress one
leaf, update it, recompress it, then the next; the reference hands the
whole tree to the rule and leaves the scheduling to XLA), and only on the
leaves that the fused kernel does not carry; ``apply_updates`` and the
fused kernel update fp32 params in place. Every inner rule of the repo is
leafwise (per-leaf norms, one shared count), so the result is the
reference's. On a mesh, ``compressed()`` marks the leaf it updates
(``sharding.context.leaf``) and the field it (de)quantizes
(``sharding.context.field``): the quantizer and the fused route then take
the rank's tile of it with the whole leaf's statistics and noise. The
rules read the rank's tile of each leaf from the mesh context and merge
what needs the whole leaf over the ranks: SM3's accumulator maxima
(``merge_max``, exact), the factored moments' means, the update clip's
RMS and Shampoo's grafting norms (``merge_sum``, each distinct box once);
Shampoo computes its statistics and inverse roots on the range of whole
blocks its stacks' tile gives the rank.
"""

from __future__ import annotations

import dataclasses
import re
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.optimizers.base import (
    FactoredMoment,
    Optimizer,
    QuantPolicy,
    compress_moment,
    decompress_moment,
    tree_order,
)
from repro_torch.core.optimizers.schedule import fp32_power
from repro_torch.core.quantizer import QuantizedTensor, quantize
from repro_torch.kernels import sr
from repro_torch.sharding import context as mesh_context

__all__ = [
    "GradientTransformation",
    "ChainState",
    "EmptyState",
    "Replace",
    "chain",
    "compressed",
    "partition",
    "PartitionState",
    "label_by_regex",
    "as_optimizer",
    "apply_updates",
    "scale_by_adam",
    "trace",
    "TraceState",
    "scale_by_sm3",
    "Sm3State",
    "scale_by_factored_rms",
    "FactoredRmsState",
    "scale_by_shampoo",
    "ScaleByShampooState",
    "EIGH",
    "add_decayed_weights",
    "scale_by_learning_rate",
    "FusedAdamWRoute",
]

Params = Dict[str, torch.Tensor]
Schedule = Union[float, Callable[[int], np.float32]]


class GradientTransformation(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Tuple[Params, Any]]


class EmptyState(NamedTuple):
    """State of a stateless transform."""


def _count0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def _resolve_lr(lr: Schedule, step: int) -> np.float32:
    return np.float32(lr(step)) if callable(lr) else np.float32(lr)


def _dev_scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 tensor on ``like``'s device, filled by a kernel (no copy).
    Dividing by it is a true division: CUDA turns division by a host
    scalar into multiplication by its reciprocal."""
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


class Replace:
    """An update leaf carrying the new parameter value verbatim (emitted by
    the fused whole-step kernel route); later transforms pass it through and
    ``apply_updates`` installs it as-is."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def _map_updates(f, updates: Params, *rest: Params) -> Params:
    return {
        k: u if isinstance(u, Replace) else f(u, *(r[k] for r in rest))
        for k, u in updates.items()
    }


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """``p' = (p_f32 + u).astype(p.dtype)``, in place for fp32 params;
    ``Replace`` leaves verbatim."""
    out = {}
    for k, p in params.items():
        u = updates[k]
        if isinstance(u, Replace):
            if u.value is not p:
                p.copy_(u.value)
        elif p.dtype == torch.float32:
            p.add_(u)
        else:
            p.copy_((p.to(torch.float32) + u).to(p.dtype))
        out[k] = p
    return out


class ChainState:
    """Tuple of per-transform states."""

    __slots__ = ("states",)

    def __init__(self, states):
        self.states = tuple(states)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Compose transforms; updates flow left to right through each."""

    def init(params):
        return ChainState(tx.init(params) for tx in transforms)

    def update(updates, state, params=None, *, key=None):
        new_states = []
        for tx, s in zip(transforms, state.states):
            updates, s2 = tx.update(updates, s, params, key=key)
            new_states.append(s2)
        return updates, ChainState(new_states)

    return GradientTransformation(init, update)


def as_optimizer(tx: GradientTransformation, name: str = "optimizer") -> Optimizer:
    """Adapt a chain to the ``(init, update) -> params`` facade. ``update``
    returns the params mapping, whose tensors were updated in place."""

    def init(params):
        return tx.init(tree_order(params))

    def update(grads, state, params, key=None):
        params = tree_order(params)
        updates, new_state = tx.update(tree_order(grads), state, params, key=key)
        return apply_updates(params, updates), new_state

    return Optimizer(init=init, update=update, name=name)


# ---------------------------------------------------------------------------
# pure update rules
# ---------------------------------------------------------------------------


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    m: Params
    v: Params


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """Bias-corrected Adam direction (paper Eq. 1): ``m̂ / (sqrt(v̂)+eps)``.
    A second-moment leaf may be a ``FactoredMoment`` (installed by
    ``compressed`` under a ``factor_2d`` policy): it is updated by its
    row/col EMA and reconstructed for the denominator."""

    def init(params):
        zeros = lambda: {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for k, p in params.items()}
        return ScaleByAdamState(_count0(), zeros(), zeros())

    def update(updates, state, params=None, *, key=None):
        count = state.count + 1
        t = int(count)
        bc1 = np.float32(1.0) - fp32_power(b1, t)
        bc2 = np.float32(1.0) - fp32_power(b2, t)
        out, new_m, new_v = {}, {}, {}
        for k, g in updates.items():
            g = g.to(torch.float32)
            m2 = b1 * state.m[k] + (1.0 - b1) * g
            v = state.v[k]
            if isinstance(v, FactoredMoment):
                tile = _tile(k, g)
                v2 = v.ema_update(g * g, b2, tile)
                v_full = v2.reconstruct(tile)
            else:
                v2 = b2 * v + (1.0 - b2) * g * g
                v_full = v2
            out[k] = (m2 / _dev_scalar(bc1, g)) / (torch.sqrt(v_full / _dev_scalar(bc2, g)) + eps)
            del v_full
            new_m[k] = m2
            new_v[k] = v2
        return out, ScaleByAdamState(count, new_m, new_v)

    return GradientTransformation(init, update)


class TraceState(NamedTuple):
    trace: Params


def trace(decay: float) -> GradientTransformation:
    """SGDM accumulator (paper Alg. 2 line 4): ``t = decay*t + g`` (no
    ``(1-decay)`` damping)."""

    def init(params):
        return TraceState({k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                           for k, p in params.items()})

    def update(updates, state, params=None, *, key=None):
        new_t = {k: decay * state.trace[k] + g.to(torch.float32) for k, g in updates.items()}
        return new_t, TraceState(new_t)

    return GradientTransformation(init, update)


def _tile(path: str, x: torch.Tensor):
    """The mesh tile of leaf ``path`` that ``x`` is (``None`` off the mesh,
    or for a whole leaf)."""
    tile = mesh_context.leaf_tile(path)
    if tile is not None and tuple(x.shape) != tile.local_shape:
        raise ValueError(f"{path}: a tensor of {tuple(x.shape)} is not this rank's tile "
                         f"{tile.box} of {tile.shape}")
    return tile


def _leaf_sum(x: torch.Tensor, tile) -> torch.Tensor:
    """``sum(x)`` over the whole leaf: a tile's partial sums merged over the
    ranks, each distinct box once."""
    s = torch.sum(x)
    if tile is None:
        return s
    from repro_torch.comms.collectives import merge_sum

    return merge_sum(s[None], take=tile.firsts())[0]


def _whole_of(x: torch.Tensor, tile) -> torch.Tensor:
    """The whole leaf from the ranks' tiles (``x`` itself off the mesh)."""
    if tile is None:
        return x
    from repro_torch.train.mesh import gather

    return gather(x, list(tile.boxes), tile.shape)


class Sm3State(NamedTuple):
    acc: Dict[str, Tuple[torch.Tensor, ...]]
    m: Params


def _broadcast_min(accs, shape):
    """nu_ij = min_r acc_r[i_r] broadcast to ``shape`` (SM3 Alg. 4 style)."""
    out = None
    for r, acc in enumerate(accs):
        view = [1] * len(shape)
        view[r] = shape[r]
        b = acc.reshape(view)
        out = b if out is None else torch.minimum(out, b)
    return out.expand(shape)


def scale_by_sm3(b1: float = 0.9, eps: float = 1e-8) -> GradientTransformation:
    """SM3 (Anil et al. 2019): sublinear accumulators (one vector per tensor
    dim; a 0-d param gets one of shape (1,)) + the β1>0 momentum variant."""

    def init(params):
        def init_acc(p):
            dims = tuple(p.shape) if p.ndim > 0 else (1,)
            return tuple(torch.zeros((d,), dtype=torch.float32, device=p.device) for d in dims)

        return Sm3State({k: init_acc(p) for k, p in params.items()},
                        {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for k, p in params.items()})

    def update(updates, state, params=None, *, key=None):
        out, new_acc = {}, {}
        for k, g in updates.items():
            g = g.to(torch.float32)
            shape = tuple(g.shape) if g.ndim > 0 else (1,)
            g_ = g.reshape(shape)
            tile, accs = _tile(k, g), state.acc[k]
            if tile is not None:  # the tile's ranges of the whole accumulators
                accs = tuple(a[lo:hi] for a, (lo, hi) in zip(accs, tile.box))
            nu = _broadcast_min(accs, shape) + g_ * g_
            # the max over every other dim (a 1-d leaf's accumulator is nu)
            new_acc[k] = tuple(
                torch.amax(nu, dim=tuple(i for i in range(len(shape)) if i != r))
                if len(shape) > 1 else nu
                for r in range(len(shape))
            )
            if tile is not None:  # placed in the whole vectors, max over the ranks
                from repro_torch.kernels.ops import merged_maxima

                new_acc[k] = merged_maxima(new_acc[k], tile.box, tile.shape)
            u = (g_ / (torch.sqrt(nu) + eps)).reshape(g.shape)
            out[k] = b1 * state.m[k] + (1 - b1) * u
        return out, Sm3State(new_acc, out)

    return GradientTransformation(init, update)


class FactoredRmsState(NamedTuple):
    count: torch.Tensor
    v: Dict[str, Any]
    m: Optional[Params]


def scale_by_factored_rms(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-30,
                          clip_threshold: float = 1.0) -> GradientTransformation:
    """Adafactor (Shazeer & Stern 2018): factored second moment for ndim>=2,
    RMS update clipping, optional first moment (``b1 == 0`` disables it)."""

    def init(params):
        v = {k: FactoredMoment.zeros(tuple(p.shape), device=p.device) if p.ndim >= 2
             else torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
        m = None
        if b1 > 0:
            m = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        return FactoredRmsState(_count0(), v, m)

    def update(updates, state, params=None, *, key=None):
        count = state.count + 1
        bc2 = np.float32(1.0) - fp32_power(b2, int(count))
        out, new_v, new_m = {}, {}, {}
        for k, g in updates.items():
            g = g.to(torch.float32)
            sq = g * g + eps
            v, tile = state.v[k], _tile(k, g)
            if isinstance(v, FactoredMoment):
                v2 = v.ema_update(sq, b2, tile)
                v_hat = v2.reconstruct(tile) / _dev_scalar(bc2, g)
            else:
                v2 = b2 * v + (1 - b2) * sq
                v_hat = v2 / _dev_scalar(bc2, g)
            del sq
            u = g / torch.sqrt(torch.clamp_min(v_hat, eps))
            del v_hat
            # update clipping: divide by max(1, RMS(u)/d), RMS over the whole leaf
            if tile is None:
                rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
            else:
                n_all = _dev_scalar(np.prod(tile.shape, dtype=np.float64), g)
                rms_u = torch.sqrt(_leaf_sum(u * u, tile) / n_all + 1e-30)
            u = u / torch.clamp_min(rms_u / _dev_scalar(clip_threshold, g), 1.0)
            if state.m is not None:
                u = b1 * state.m[k] + (1 - b1) * u
                new_m[k] = u
            out[k] = u
            new_v[k] = v2
        return out, FactoredRmsState(count, new_v, new_m if state.m is not None else None)

    return GradientTransformation(init, update)


class ScaleByShampooState(NamedTuple):
    count: torch.Tensor
    m: Params  # grafting first moment (Adam m)
    v: Params  # grafting second moment (Adam v)
    stats_l: Params  # (nblocks, Br, Br) left Kronecker statistics L += G Gᵀ
    stats_r: Params  # (nblocks, Bc, Bc) right Kronecker statistics R += Gᵀ G
    precond_l: Params  # (nblocks, Br, Br) L^{-1/4}
    precond_r: Params  # (nblocks, Bc, Bc) R^{-1/4}


def _shampoo_geometry(shape: Tuple[int, ...], block_size: int):
    """Static blocking of a >=2-d param: leading dims merge into rows, the
    trailing dim is columns; each dim tiles at min(block_size, dim)."""
    n = 1
    for d in shape[:-1]:
        n *= int(d)
    m = int(shape[-1])
    br = min(block_size, n)
    bc = min(block_size, m)
    return n, m, br, bc, -(-n // br), -(-m // bc)


def _shampoo_to_blocks(x2d, n, m, br, bc, nb_r, nb_c):
    x = F.pad(x2d, (0, nb_c * bc - m, 0, nb_r * br - n))
    x = x.reshape(nb_r, br, nb_c, bc).permute(0, 2, 1, 3)
    return x.reshape(nb_r * nb_c, br, bc)


def _shampoo_from_blocks(bx, n, m, br, bc, nb_r, nb_c):
    x = bx.reshape(nb_r, nb_c, br, bc).permute(0, 2, 1, 3)
    return x.reshape(nb_r * br, nb_c * bc)[:n, :m]


def _shampoo_pad_diag(n, m, br, bc, nb_r, nb_c, device=None):
    """Per-block diagonal indicators of padded rows/cols: padded dims get
    +1.0 on the statistics diagonal before the inverse root, so their
    eigenvalues sit at ~1.0 (inert) instead of at the ridge, whose
    ridge^{-1/4} would poison the blockwise scales of quantized factors."""
    rows = np.arange(nb_r * br).reshape(nb_r, br) >= n
    cols = np.arange(nb_c * bc).reshape(nb_c, bc) >= m
    pad_l = np.repeat(rows, nb_c, axis=0).astype(np.float32)  # (nb, br)
    pad_r = np.tile(cols, (nb_r, 1)).astype(np.float32)  # (nb, bc)
    return torch.from_numpy(pad_l).to(device), torch.from_numpy(pad_r).to(device)


# eigh work of ``_inv_quarter_root`` since the last reset: batched calls,
# blocks and host seconds
EIGH: Dict[str, float] = {"calls": 0, "blocks": 0, "s": 0.0}


def _eigh_one_thread(a):
    torch.set_num_threads(1)
    return torch.linalg.eigh(a)


def host_eigh(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` of a batch on the host: its slices on the
    process's intra-op threads side by side, each matrix on one thread, so a
    block's result does not depend on the thread count. A batch on the card
    comes here: cuSOLVER decomposes it one call per matrix, 0.96-2.0 ms a
    128 x 128 block on an H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase
    11), where the host's threads take their slices at once."""
    threads = torch.get_num_threads()
    n = max(1, min(threads, a.shape[0]))
    try:
        with ThreadPoolExecutor(n) as pool:
            parts = list(pool.map(_eigh_one_thread, a.chunk(n)))
    finally:
        torch.set_num_threads(threads)
    return torch.cat([w for w, _ in parts]), torch.cat([u for _, u in parts])


def _inv_quarter_root(stats, pad_diag, ridge, floor_rel):
    """(stats + ridge*I + diag(pad))^{-1/4} per block, by batched eigh, with
    eigenvalues floored at ``max(ridge, floor_rel * λ_max)`` per block: the
    relative floor caps the amplification of the spurious near-zero
    eigenvalues that 4-bit requantization noise manufactures. The input is
    symmetrized first, as ``jnp.linalg.eigh`` does by default: a factor
    dequantized from row-wise blocks is not symmetric, and
    ``torch.linalg.eigh`` would read its lower triangle alone."""
    d = stats.shape[-1]
    eye = torch.eye(d, dtype=torch.float32, device=stats.device)
    a = stats + ridge * eye + pad_diag[:, :, None] * eye
    a = (a + a.transpose(-1, -2)) / 2
    t0 = time.perf_counter()
    if a.device.type == "cuda":
        w, u = (x.to(a.device) for x in host_eigh(a.cpu()))
    else:
        w, u = torch.linalg.eigh(a)
    EIGH["s"] += time.perf_counter() - t0
    EIGH["calls"] += 1
    EIGH["blocks"] += a.shape[0]
    del a
    wmax = torch.amax(w, dim=-1, keepdim=True)
    w = torch.maximum(w, torch.clamp_min(floor_rel * wmax, ridge))
    return (u * w.pow(-0.25)[:, None, :]) @ u.transpose(-1, -2)


def scale_by_shampoo(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, *,
                     block_size: int = 128, precond_every: int = 10, matrix_eps: float = 1e-6,
                     floor_rel: float = 0.01) -> GradientTransformation:
    """Blocked Shampoo (Gupta et al. 2018, block-diagonal as in Anil et al.
    2020) with AdamW grafting. Each >=2-d param is matricized (leading dims
    -> rows) and tiled into blocks of at most ``block_size`` a side; per
    block ``L <- b2 L + (1-b2) G Gᵀ``, ``R <- b2 R + (1-b2) Gᵀ G``, the
    inverse fourth roots recomputed at step 1 and every ``precond_every``
    steps after (a host decision on the host count; the stale roots are
    reused between), and the direction ``P_L m̂ P_R`` grafted onto the AdamW
    direction's norm per leaf. Params with ndim < 2 take the AdamW
    direction and hold ``(0,)`` factor placeholders.

    On a mesh the geometry is the whole leaf's. A rank holds its blocks
    ``[b0, b1)`` of each factor stack (the box of the ``stats_l`` field's
    tile on dim 0; every block off the mesh): the gradient and ``m̂`` are
    gathered whole and cut to those blocks, their statistics and roots
    computed there alone, and the direction's blocks gathered over the
    ranks and cut back to the parameter's tile; the grafting norms are
    sums over the whole leaf."""

    def _placeholder(p):
        return torch.zeros((0,), dtype=torch.float32, device=p.device)

    def init(params):
        zeros = lambda: {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for k, p in params.items()}

        def factor(p, side, identity):
            if p.ndim < 2:
                return _placeholder(p)
            n, m, br, bc, nb_r, nb_c = _shampoo_geometry(tuple(p.shape), block_size)
            d = br if side == "l" else bc
            base = torch.zeros((nb_r * nb_c, d, d), dtype=torch.float32, device=p.device)
            return base + torch.eye(d, dtype=torch.float32, device=p.device) if identity else base

        f = lambda side, identity: {k: factor(p, side, identity) for k, p in params.items()}
        return ScaleByShampooState(_count0(), zeros(), zeros(), f("l", False), f("r", False),
                                   f("l", True), f("r", True))

    def update(updates, state, params=None, *, key=None):
        count = state.count + 1
        t = int(count)
        bc1 = np.float32(1.0) - fp32_power(b1, t)
        bc2 = np.float32(1.0) - fp32_power(b2, t)
        recompute = (t - 1) % precond_every == 0
        out = {}
        new = {name: {} for name in ScaleByShampooState._fields[1:]}
        for k, g in updates.items():
            g = g.to(torch.float32)
            tile = _tile(k, g)
            m2 = b1 * state.m[k] + (1.0 - b1) * g
            v2 = b2 * state.v[k] + (1.0 - b2) * g * g
            m_hat = m2 / _dev_scalar(bc1, g)
            adam_dir = m_hat / (torch.sqrt(v2 / _dev_scalar(bc2, g)) + eps)
            new["m"][k], new["v"][k] = m2, v2
            if g.ndim < 2:
                out[k] = adam_dir
                for name in ("stats_l", "stats_r", "precond_l", "precond_r"):
                    new[name][k] = getattr(state, name)[k]
                continue
            shape = tile.shape if tile is not None else tuple(g.shape)
            geo = _shampoo_geometry(shape, block_size)
            n, mm = geo[0], geo[1]
            # this rank's blocks: the stacks' tile on dim 0 (every block off the mesh)
            blocks = mesh_context.leaf_tile(k, "stats_l")
            b0, b1_ = blocks.box[0] if blocks is not None else (0, geo[4] * geo[5])
            to_blocks = lambda x: _shampoo_to_blocks(_whole_of(x, tile).reshape(n, mm),
                                                     *geo)[b0:b1_]
            gb = to_blocks(g)
            sl2 = b2 * state.stats_l[k] + (1.0 - b2) * (gb @ gb.transpose(-1, -2))
            sr2 = b2 * state.stats_r[k] + (1.0 - b2) * (gb.transpose(-1, -2) @ gb)
            del gb
            if recompute:
                pad_l, pad_r = _shampoo_pad_diag(*geo, device=g.device)
                pl2 = _inv_quarter_root(sl2 / _dev_scalar(bc2, g), pad_l[b0:b1_], matrix_eps,
                                        floor_rel)
                pr2 = _inv_quarter_root(sr2 / _dev_scalar(bc2, g), pad_r[b0:b1_], matrix_eps,
                                        floor_rel)
            else:
                pl2, pr2 = state.precond_l[k], state.precond_r[k]
            db = pl2 @ to_blocks(m_hat) @ pr2
            del m_hat
            if blocks is not None:  # every rank's blocks
                from repro_torch.train.mesh import gather

                rest = tuple((0, int(x)) for x in db.shape[1:])
                db = gather(db, [b[:1] + rest for b in blocks.boxes],
                            blocks.shape[:1] + tuple(db.shape[1:]))
            d = _shampoo_from_blocks(db, *geo).reshape(shape)
            del db
            if tile is not None:
                d = d[tile.index()]
            a_norm = torch.sqrt(_leaf_sum(adam_dir * adam_dir, tile))
            d_norm = torch.sqrt(_leaf_sum(d * d, tile))
            out[k] = d * (a_norm / (d_norm + 1e-30))
            del d, adam_dir
            new["stats_l"][k], new["stats_r"][k] = sl2, sr2
            new["precond_l"][k], new["precond_r"][k] = pl2, pr2
        return out, ScaleByShampooState(count, **new)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """Decoupled weight decay: ``u <- u + weight_decay * p``."""

    def init(params):
        return EmptyState()

    def update(updates, state, params=None, *, key=None):
        return _map_updates(lambda u, p: u + weight_decay * p, updates, params), state

    return GradientTransformation(init, update)


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


def scale_by_learning_rate(lr: Schedule, flip_sign: bool = True) -> GradientTransformation:
    """Multiply updates by ``-lr(step)`` (its own step count)."""

    def init(params):
        return ScaleByScheduleState(_count0())

    def update(updates, state, params=None, *, key=None):
        count = state.count + 1
        lr_t = _resolve_lr(lr, int(count))
        mult = float(-lr_t if flip_sign else lr_t)
        return _map_updates(lambda u: u * mult, updates), ScaleByScheduleState(count)

    return GradientTransformation(init, update)


# ---------------------------------------------------------------------------
# compressed(): the one Alg. 1 wrapper
# ---------------------------------------------------------------------------


class CompressedState(NamedTuple):
    count: torch.Tensor
    inner: Any


@dataclasses.dataclass(frozen=True)
class FusedAdamWRoute:
    """Routes eligible (p, g, m̄, v̄) leaves through the fused CUDA kernel,
    which computes the whole AdamW step and emits a ``Replace`` leaf.
    Eligibility is the kernel's layout contract: 4-bit B128 m, 4-bit rank-1
    v, matching SR settings, ndim >= 2 with the last dim a multiple of 256."""

    lr: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    m_field: str = "m"
    v_field: str = "v"

    def eligible(self, comp: Mapping[str, Any], p: torch.Tensor) -> bool:
        """By the whole leaf's shape: on a mesh, ``p`` is a rank's tile and
        the route stays the one-device route (``sharding.context``)."""
        tile = mesh_context.current_tile()
        shape = tile.shape if tile is not None else tuple(p.shape)
        m_s = comp.get(self.m_field)
        v_s = comp.get(self.v_field)
        return (
            isinstance(m_s, QuantizedTensor)
            and m_s.config.bits == 4
            and m_s.config.normalization == "blockwise"
            and m_s.config.block_size == 128
            and isinstance(v_s, QuantizedTensor)
            and v_s.config.bits == 4
            and v_s.config.normalization == "rank1"
            and m_s.config.stochastic_rounding == v_s.config.stochastic_rounding
            and len(shape) >= 2
            and shape[-1] % 256 == 0
        )

    def run(self, p, g, comp, step: int, key=None):
        from repro_torch.kernels import ops as kernel_ops

        lr_t = _resolve_lr(self.lr, step)
        bc1 = np.float32(1.0) - fp32_power(self.b1, step)
        bc2 = np.float32(1.0) - fp32_power(self.b2, step)
        w_new, m2, v2 = kernel_ops.fused_adamw4_leaf(
            p, g, comp[self.m_field], comp[self.v_field],
            lr_t, self.b1, self.b2, self.eps, self.weight_decay, bc1, bc2, key=key,
        )
        return w_new, {self.m_field: m2, self.v_field: v2}


def compressed(inner: GradientTransformation, policies: Mapping[str, QuantPolicy], *,
               kernel: Optional[FusedAdamWRoute] = None) -> GradientTransformation:
    """Wrap ``inner`` so the state fields named by ``policies`` persist
    compressed (Alg. 1): quantized, factored or raw per leaf; ``kernel``
    routes eligible leaves through the fused whole-step kernel.

    Both ``init`` and ``update`` go one leaf at a time, so no whole fp32 tree
    of a compressed field ever exists: the inner rule sees a one-leaf state
    (its per-leaf fields cut to the leaf, its shared fields, the count, as
    they were), and one call on an empty tree advances the shared fields
    once per step. SR keys are ``fold_in(key, i)`` over the full leaf order
    and ``split`` over the fields, as in the reference."""
    policies = dict(policies)
    names = tuple(policies)

    def per_leaf_fields(state):
        return tuple(f for f in state._fields if isinstance(getattr(state, f), dict))

    def init(params):
        skeleton = inner.init({})  # the shared fields; the per-leaf ones empty
        fields = per_leaf_fields(skeleton)
        out = {f: {} for f in fields}
        for k, p in params.items():
            one = inner.init({k: p})
            for f in fields:
                pol = policies.get(f)
                mode = pol.mode(k, tuple(p.shape)) if pol is not None else "raw"
                if mode == "factor":
                    out[f][k] = FactoredMoment.zeros(tuple(p.shape), device=p.device)
                elif pol is not None:
                    out[f][k] = compress_moment(getattr(one, f)[k], mode, pol.config)
                else:
                    out[f][k] = getattr(one, f)[k]
            del one
        return CompressedState(_count0(), skeleton._replace(**out))

    @torch.no_grad()
    def update(updates, state, params=None, *, key=None):
        count = state.count + 1
        step = int(count)
        fields = per_leaf_fields(state.inner)
        _, shared = inner.update({}, state.inner._replace(**{f: {} for f in fields}), {},
                                 key=key)
        out_u: Params = {}
        new = {f: {} for f in fields}
        for i, k in enumerate(updates):
            with mesh_context.leaf(k):  # a no-op off the mesh
                lk = sr.fold_in(key, i) if key is not None else None
                comp = {name: getattr(state.inner, name)[k] for name in names}
                if kernel is not None and kernel.eligible(comp, params[k]):
                    w_new, nc = kernel.run(params[k], updates[k], comp, step, key=lk)
                    out_u[k] = Replace(w_new)
                    for f in fields:
                        new[f][k] = nc[f] if f in nc else getattr(state.inner, f)[k]
                    continue
                # Alg. 1 lines 3-4 on this leaf alone: fp32 views of quantized
                # moments (FactoredMoment and raw leaves pass through structurally)
                view = {}
                for f in fields:
                    x = getattr(state.inner, f)[k]
                    with mesh_context.field(f):
                        view[f] = {k: decompress_moment(x) if isinstance(x, QuantizedTensor)
                                   else x}
                u, one = inner.update({k: updates[k]}, state.inner._replace(**view),
                                      {k: params[k]} if params is not None else None, key=key)
                del view
                out_u[k] = u[k]
                # Alg. 1 line 5: recompress with per-leaf, per-field SR keys
                fkeys = (dict(zip(names, sr.split(lk, len(names))))
                         if lk is not None and len(names) > 1 else {n: lk for n in names})
                for f in fields:
                    old, x = getattr(state.inner, f)[k], getattr(one, f)[k]
                    with mesh_context.field(f):
                        new[f][k] = (quantize(x, old.config, key=fkeys[f])
                                     if isinstance(old, QuantizedTensor) else x)
                del u, one
        return out_u, CompressedState(count, shared._replace(**new))

    return GradientTransformation(init, update)


# ---------------------------------------------------------------------------
# partition(): per-subtree transform routing
# ---------------------------------------------------------------------------


class PartitionState:
    """Per-label sub-states plus the init-time param paths."""

    __slots__ = ("states", "param_paths")

    def __init__(self, states, param_paths=None):
        self.states = {k: states[k] for k in sorted(states)}
        self.param_paths = None if param_paths is None else tuple(param_paths)


def label_by_regex(patterns, match_label: str, default_label: str) -> Callable[[str, Any], str]:
    """Label fn: ``match_label`` when the path matches any regex."""
    pats = tuple(patterns)

    def fn(path: str, leaf) -> str:
        return match_label if any(re.search(p, path) for p in pats) else default_label

    return fn


def partition(transforms: Mapping[str, GradientTransformation], labels) -> GradientTransformation:
    """Route parameter leaves to different transforms by label (a mapping
    ``{path: label}`` or a callable ``(path, param) -> label``). Each
    sub-transform sees only its own leaves, in the reference's order, so
    leaf indices restart at 0 inside each partition as they do there."""
    transforms = dict(transforms)
    label_order = {lab: i for i, lab in enumerate(sorted(transforms))}

    def _labels(params):
        labs = {k: (labels(k, p) if callable(labels) else labels[k]) for k, p in params.items()}
        for lab in labs.values():
            if lab not in transforms:
                raise ValueError(
                    f"partition(): label {lab!r} has no transform; known labels: {sorted(transforms)}"
                )
        return labs

    def _mask(tree, labs, lab):
        return {k: v for k, v in tree.items() if labs[k] == lab}

    def init(params):
        labs = _labels(params)
        return PartitionState(
            {lab: tx.init(_mask(params, labs, lab)) for lab, tx in transforms.items()},
            tuple(params),
        )

    def update(updates, state, params=None, *, key=None):
        cur = tuple(params)
        if state.param_paths is not None and cur != state.param_paths:
            added = set(cur) - set(state.param_paths)
            removed = set(state.param_paths) - set(cur)
            raise KeyError(
                "partition(): param tree changed since init() — "
                f"added {sorted(added)}, removed {sorted(removed)}; re-init the optimizer state"
            )
        labs = _labels(params)
        merged: Params = {}
        new_states = {}
        for lab, tx in transforms.items():
            k_lab = sr.fold_in(key, label_order[lab]) if key is not None else None
            u_l, s_l = tx.update(_mask(updates, labs, lab), state.states[lab],
                                 _mask(params, labs, lab), key=k_lab)
            merged.update(u_l)
            new_states[lab] = s_l
        return {k: merged[k] for k in params}, PartitionState(new_states, state.param_paths)

    return GradientTransformation(init, update)

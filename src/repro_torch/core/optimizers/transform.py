"""Composable gradient transformations with the one compressed-state wrapper
of Alg. 1 — port of ``repro/core/optimizers/transform.py`` for the rules
that ``production4bit``, the AdamW family and SGDM use.

Trees are ordered ``{path: tensor}`` mappings in the reference's leaf order.
A ``GradientTransformation`` is an ``(init, update)`` pair over updates:
``update(updates, state, params=None, *, key=None) -> (updates, state)``.
Keys are host ``(k0, k1)`` pairs from ``repro_torch.kernels.sr``; step
counts are host-side int32 tensors, so learning rates and bias corrections
are host fp32 values and reading them never waits for the device.

Differences from the functional reference, all for memory on the card:
the inner rule runs only on leaves that the fused kernel does not carry
(the reference computes them all and lets jit drop the unused ones), and
``apply_updates`` and the fused kernel update fp32 params in place.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.optimizers.base import (
    Optimizer,
    QuantPolicy,
    compress_moment,
    decompress_moment,
    tree_order,
)
from repro_torch.core.optimizers.schedule import fp32_power
from repro_torch.core.quantizer import QuantizedTensor, quantize
from repro_torch.kernels import sr

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
    """Bias-corrected Adam direction (paper Eq. 1): ``m̂ / (sqrt(v̂)+eps)``."""

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
            v2 = b2 * state.v[k] + (1.0 - b2) * g * g
            out[k] = (m2 / _dev_scalar(bc1, g)) / (torch.sqrt(v2 / _dev_scalar(bc2, g)) + eps)
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
            and p.ndim >= 2
            and p.shape[-1] % 256 == 0
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
    compressed (Alg. 1); ``kernel`` routes eligible leaves through the fused
    whole-step kernel."""
    policies = dict(policies)
    names = tuple(policies)

    def init(params):
        inner_state = inner.init(params)
        repl = {}
        for name, pol in policies.items():
            field = getattr(inner_state, name)
            repl[name] = {
                k: compress_moment(field[k], pol.mode(k, tuple(p.shape)), pol.config)
                for k, p in params.items()
            }
        return CompressedState(_count0(), inner_state._replace(**repl))

    @torch.no_grad()
    def update(updates, state, params=None, *, key=None):
        count = state.count + 1
        step = int(count)
        comp = {name: getattr(state.inner, name) for name in names}
        keys = list(updates)
        leaf_keys = {k: (sr.fold_in(key, i) if key is not None else None)
                     for i, k in enumerate(keys)}
        fused = [
            k for k in keys
            if kernel is not None and kernel.eligible({n: comp[n][k] for n in names}, params[k])
        ]
        rest = [k for k in keys if k not in set(fused)]

        # Alg. 1 lines 3-4 on the leaves the kernel does not carry
        sub = lambda d: {k: d[k] for k in rest}
        dec = {name: {k: decompress_moment(comp[name][k]) for k in rest} for name in names}
        inner_u, new_inner = inner.update(
            sub(updates), state.inner._replace(**dec), sub(params), key=key
        )

        out_u: Params = {}
        new_comp = {name: {} for name in names}
        for k in keys:
            if k in inner_u:
                out_u[k] = inner_u[k]
                # Alg. 1 line 5: recompress with per-leaf, per-moment SR keys
                lk = leaf_keys[k]
                fkeys = (dict(zip(names, sr.split(lk, len(names))))
                         if lk is not None and len(names) > 1 else {n: lk for n in names})
                for name in names:
                    old = comp[name][k]
                    new = getattr(new_inner, name)[k]
                    new_comp[name][k] = (quantize(new, old.config, key=fkeys[name])
                                         if isinstance(old, QuantizedTensor) else new)
            else:
                w_new, nc = kernel.run(params[k], updates[k],
                                       {n: comp[n][k] for n in names}, step, key=leaf_keys[k])
                out_u[k] = Replace(w_new)
                for name in names:
                    new_comp[name][k] = nc[name]
        return out_u, CompressedState(count, new_inner._replace(**new_comp))

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

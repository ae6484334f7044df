"""Training step (port of ``repro/train/train_loop.py``).

``build_train_step(model, optimizer, comms=)`` returns ``train_step(state,
batch) -> (state, metrics)``: loss and gradients by autograd (with
``accum_steps`` microbatches accumulated in fp32), the gradient wire format
of ``comms`` (``repro_torch.comms``; its stochastic rounding keyed by
``grad_comm_key(state.key, state.step)``), then the optimizer update with
the stochastic-rounding key ``fold_in(state.key, state.step)``, so both key
streams are pure functions of (base key, step) as in the reference. The
params are the model's own tensors, updated in place.

With ``mesh`` (a ``launch.mesh.make_mesh`` of ``torch.distributed``
ranks) the step is the mesh step of ``train.mesh``: ``shard_train_state``
first cuts a whole state to this rank's part of every tensor under
``train_state_shardings`` (the plans of ``sharding.specs``, with ZeRO on
the data axes by default), and the step gathers each layer's parameters
when the layer loop reaches it (a leaf that computes tensor-parallel on
the model axis as the rank's model shard, ``sharding.tensor_parallel``),
sends each gradient tile to its owner, and updates the tiles. The
one-device path is unchanged.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.comms import CommsConfig, grad_comm_key, reduce_grads
from repro_torch.core.optimizers.base import Optimizer
from repro_torch.kernels import sr
from repro_torch.models import Transformer, init_model, loss_fn, named_params, param_axes
from repro_torch.sharding.rules import P

__all__ = ["TrainState", "make_train_state", "build_train_step", "train_state_shardings",
           "shard_train_state"]


@dataclasses.dataclass
class TrainState:
    """params (fp32 masters, the model's tensors) + optimizer state + step
    counter + optional SR base key (a host ``(k0, k1)`` pair)."""

    params: Dict[str, torch.nn.Parameter]
    opt_state: Any
    step: int = 0
    key: Optional[Tuple[int, int]] = None


def make_train_state(model: Transformer, optimizer: Optimizer,
                     key: Optional[Tuple[int, int]] = None) -> TrainState:
    """``key`` seeds stochastic rounding (e.g. ``sr.PRNGKey(seed)``)."""
    params = named_params(model)
    with torch.no_grad():
        opt_state = optimizer.init(params)
    return TrainState(params, opt_state, 0, key)


def _microbatch(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of one batch leaf, sliced on its batch dim
    by the reference's rule: dim 1 for M-RoPE positions ``(3, B, S)``
    (``shape[0] == 3 != shape[1]``), else dim 0."""
    if x.dim() == 0:
        return x
    bdim = 1 if x.dim() >= 2 and x.shape[0] == 3 and x.shape[1] != 3 else 0
    B = x.shape[bdim]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    return x.narrow(bdim, i * (B // n), B // n)


def train_state_shardings(state: TrainState, axes, mesh, zero: bool = True) -> TrainState:
    """The plan of a whole train state: ``TrainState`` of partitions."""
    from repro_torch.sharding.specs import opt_state_shardings, param_shardings

    return TrainState(params=param_shardings(state.params, axes, mesh, zero=zero),
                      opt_state=opt_state_shardings(state.opt_state, state.params, axes, mesh,
                                                    zero=zero),
                      step=P(), key=None if state.key is None else P())


@torch.no_grad()
def shard_train_state(state: TrainState, mesh, axes, zero: bool = True) -> TrainState:
    """This rank's part of a whole ``state`` under ``train_state_shardings``,
    as new tensors; the whole tensors are freed (the parameters' storage,
    which the model shares, is released, and ``state`` is emptied)."""
    from repro_torch.sharding.context import rank_coord
    from repro_torch.sharding.specs import local_slice, map_plan

    plan = train_state_shardings(state, axes, mesh, zero)
    coord = rank_coord(mesh)
    cut = lambda t, spec: local_slice(t, spec, coord, mesh).clone()
    params = {k: cut(p.detach(), plan.params[k]) for k, p in state.params.items()}
    opt = map_plan(cut, state.opt_state, plan.opt_state)
    for p in state.params.values():
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)
    out = TrainState(params, opt, state.step, state.key)
    state.params, state.opt_state = {}, None
    return out


def build_train_step(model: Transformer, optimizer: Optimizer, mesh=None, axes=None, *,
                     zero: bool = True, accum_steps: int = 1,
                     comms: Optional[CommsConfig] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics are
    0-d tensors on the model's device (reading them waits for the step).
    ``comms`` selects the gradient wire format (fp32 by default). With
    ``mesh`` the step runs on this rank's part of a state made by
    ``shard_train_state`` (``axes``: ``models.param_axes(cfg)`` by default)
    and takes the whole global batch, of which it computes its data shard."""
    comms = comms if comms is not None else CommsConfig()
    if mesh is not None:
        return _build_mesh_step(model, optimizer, mesh, axes, zero, accum_steps, comms)

    def compute_grads(batch):
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        return loss.detach(), metrics

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        for p in params.values():
            p.grad = None
        if accum_steps > 1:
            loss_sum, mets = 0.0, []
            for i in range(accum_steps):
                micro = {k: _microbatch(v, i, accum_steps) for k, v in batch.items()}
                loss_i, m_i = compute_grads(micro)
                loss_sum = loss_sum + loss_i
                mets.append(m_i)
            # autograd summed the microbatch grads in fp32; the mean is theirs
            grads = {k: p.grad / accum_steps for k, p in params.items()}
            loss = loss_sum / accum_steps
            metrics = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
        else:
            loss, metrics = compute_grads(batch)
            grads = {k: p.grad for k, p in params.items()}

        # the gradient wire format; its transport SR key is domain-separated
        # from the optimizer-state stream
        if comms.compresses:
            ck = (grad_comm_key(state.key, state.step)
                  if comms.quantized and comms.stochastic_rounding else None)
            grads = reduce_grads(grads, None, None, comms, key=ck)

        step_key = sr.fold_in(state.key, state.step) if state.key is not None else None
        with torch.no_grad():
            _, new_opt = optimizer.update(grads, state.opt_state, params, key=step_key)
            grad_norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads.values()))
        for p in params.values():
            p.grad = None
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = grad_norm
        return TrainState(params, new_opt, state.step + 1, state.key), metrics

    return train_step


def _build_mesh_step(model, optimizer, mesh, axes, zero, accum_steps, comms) -> Callable:
    from repro_torch.sharding import context
    from repro_torch.train.mesh import STATS, MeshStep

    cfg = model.cfg
    axes = dict(axes) if axes is not None else param_axes(cfg)
    meta = named_params(init_model(cfg, device="meta"))
    with torch.no_grad():
        meta_state = optimizer.init(meta)
    run = context.MeshRun(mesh)
    ms = MeshStep(run, cfg, {k: tuple(p.shape) for k, p in meta.items()}, axes, meta,
                  meta_state, zero=zero)
    del meta_state
    sync = lambda: torch.cuda.synchronize() if torch.cuda.is_available() else None

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        STATS["collective_s"], STATS["bytes"] = 0.0, 0
        t0 = time.perf_counter()
        grads, metrics = ms.forward_backward(state.params, batch, accum_steps)
        sync()
        t1, c1 = time.perf_counter(), STATS["collective_s"]
        new_opt, metrics["grad_norm"] = ms.finish(optimizer, grads, state.opt_state,
                                                  state.params, state.key, state.step, comms)
        sync()
        t2 = time.perf_counter()
        train_step.times = {"fwd_bwd_s": t1 - t0, "update_s": t2 - t1,
                            "collective_fwd_bwd_s": c1,
                            "collective_update_s": STATS["collective_s"] - c1,
                            "collective_bytes": STATS["bytes"]}
        return TrainState(state.params, new_opt, state.step + 1, state.key), metrics

    train_step.mesh_step = ms
    return train_step

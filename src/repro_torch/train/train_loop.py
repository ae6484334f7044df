"""Single-device training step (port of ``repro/train/train_loop.py``
without the mesh).

``build_train_step(model, optimizer, comms=)`` returns ``train_step(state,
batch) -> (state, metrics)``: loss and gradients by autograd (with
``accum_steps`` microbatches accumulated in fp32), the gradient wire format
of ``comms`` (``repro_torch.comms``; its stochastic rounding keyed by
``grad_comm_key(state.key, state.step)``), then the optimizer update with
the stochastic-rounding key ``fold_in(state.key, state.step)``, so both key
streams are pure functions of (base key, step) as in the reference. The
params are the model's own tensors, updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.comms import CommsConfig, grad_comm_key, reduce_grads
from repro_torch.core.optimizers.base import Optimizer
from repro_torch.kernels import sr
from repro_torch.models import Transformer, loss_fn, named_params

__all__ = ["TrainState", "make_train_state", "build_train_step"]


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


def build_train_step(model: Transformer, optimizer: Optimizer, *, accum_steps: int = 1,
                     comms: Optional[CommsConfig] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics are
    0-d tensors on the model's device (reading them waits for the step).
    ``comms`` selects the gradient wire format (fp32 by default)."""
    comms = comms if comms is not None else CommsConfig()

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

"""Recompute in the backward: the port's ``jax.checkpoint``.

``recomputed(fn, *args)`` runs ``fn`` so that autograd saves none of its
intermediate tensors: the backward runs ``fn`` again, from the same inputs,
when it first needs one of them (``torch.utils.checkpoint``, non-reentrant,
so regions nest: the training attention's block pairs inside a layer). The
recompute runs the whole region again (no early stop), so every collective
inside it (a mesh layer's gathers, the model group's sums) runs again, on
every rank, in the forward's order; the graph it builds is dropped, and the
backward runs the forward's own nodes (a gather's gradient goes to its
owners once). The port's context variables (``repro_*``: the
tensor-parallel group, the mesh's batch shards, a collective's dry world)
hold in the recompute what they held in the forward, on whichever thread
autograd runs it. The forward draws no random numbers, so no RNG state is
kept. Without autograd, ``fn`` runs as it is.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Dict, Iterator

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

__all__ = ["recomputed"]


@contextlib.contextmanager
def _entered(values: Dict[contextvars.ContextVar, Any]) -> Iterator[None]:
    tokens = [(var, var.set(value)) for var, value in values.items()]
    try:
        yield
    finally:
        for var, token in reversed(tokens):
            var.reset(token)


def recomputed(fn: Callable, *args):
    """``fn(*args)``, its intermediates recomputed in the backward, not saved."""
    if not torch.is_grad_enabled():
        return fn(*args)
    values = {var: value for var, value in contextvars.copy_context().items()
              if var.name.startswith("repro_")}
    with set_checkpoint_early_stop(False):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(), _entered(values)))

"""The reference's side of the port's tensor-parallel end-to-end tests
(``tests/test_torch_tp_{train,archs}.py``; JAX on the 8 host devices that
``tests/conftest.py`` forces): the jitted step's losses on a layout, and
the loss's gradient by ``jax.grad``; the port's one-process gradient at the
same params; and the gap of a gradient tree to another.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

from repro.core.optimizers import make_optimizer as j_make
from repro.models import init_model as j_init, loss_fn as j_loss
from repro.sharding import batch_shardings as j_batch_shardings
from repro.train.train_loop import (
    build_train_step as j_build,
    jit_train_step as j_jit,
    make_train_state as j_make_state,
    train_state_shardings as j_state_shardings,
)
from repro_torch.convert import load_params, params_from_jax
from repro_torch.models import Transformer, loss_fn

LR, SEED = 1e-3, 0


def flat(tree):
    """A reference tree as ``{port path: numpy}``."""
    return {k: v.numpy() for k, v in params_from_jax(jax.device_get(tree), "cpu").items()}


def ref_axes(cfg):
    out = {}

    def init():
        params, out["axes"] = j_init(jax.random.PRNGKey(0), cfg)
        return params

    jax.eval_shape(init)
    return out["axes"]


def ref_losses(cfg, p, batches, layout):
    """The reference's jitted production4bit+SR step on a (data, model)
    layout of the host devices: its losses over ``batches``."""
    opt = j_make("production4bit", LR)
    n = layout[0] * layout[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(layout), ("data", "model"))
    jaxes = ref_axes(cfg)
    state = j_make_state(p, opt, key=jax.random.PRNGKey(SEED))
    state = jax.device_put(state, j_state_shardings(state, jaxes, mesh))
    placed = [jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                             j_batch_shardings(b, mesh)) for b in batches]
    step = j_jit(j_build(cfg, opt, mesh, jaxes, zero=True), state, placed[0], jaxes, mesh)
    losses = []
    for b in placed:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses


def ref_grads(cfg, p, batch):
    """``jax.grad`` of the reference's loss at ``p`` on ``batch``."""
    g = jax.jit(jax.grad(lambda p, b: j_loss(p, cfg, b)[0]))(
        p, {k: jnp.asarray(v) for k, v in batch.items()})
    return flat(g)


def port_grads(cfg, params, batch):
    """The port's one-process gradient at ``params`` (``{path: numpy}``)."""
    model = Transformer(cfg, device="cpu")
    load_params(model, {k: torch.from_numpy(v) for k, v in params.items()})
    loss, _ = loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return {k.replace(".", "/"): p.grad.numpy() for k, p in model.named_parameters()}


def gaps(got, want):
    """Each leaf's relative error in the 2-norm, as
    ``tests/test_torch_train.py`` measures the one-process gradient."""
    return {k: float(np.linalg.norm(np.asarray(got[k], np.float32) - want[k])
                     / max(np.linalg.norm(want[k]), 1e-12)) for k in want}

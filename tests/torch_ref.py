"""The reference's params for the port's tests, jitted once per config in a
process (imported by the test modules; JAX on the CPU).

A fresh ``jax.jit`` of a new lambda compiles again: 2-6 s a reduced config
on the CPU, and most parity files build the same arch's params in several
tests. ``ref_params(cfg, seed)`` is ``init_model(PRNGKey(seed), cfg)[0]``
(configs are frozen dataclasses, so equal configs share one entry).
"""

import functools

import jax

from repro.models import init_model


@functools.lru_cache(maxsize=None)
def _init_fn(cfg):
    return jax.jit(lambda k: init_model(k, cfg)[0])


@functools.lru_cache(maxsize=None)
def ref_params(cfg, seed: int = 0):
    """The reference's params of ``cfg`` from ``PRNGKey(seed)`` (JAX arrays:
    immutable, so the cached tree is shared)."""
    return _init_fn(cfg)(jax.random.PRNGKey(seed))

"""The optimizers on the port's MoE trees against the JAX reference, and the
structural byte counts of phi3.5-moe-42b-a6.6b and mixtral-8x7b.

(``tests/test_torch_moe_train.py`` holds production4bit's updates bit for
bit.)

* Each of the eleven optimizers, two steps of the port on reduced
  phi3.5-moe: the state's structure, leaf keys, shapes and dtypes and its
  bytes equal the reference's (``jax.eval_shape`` of its init and two
  updates).
* Each of the eleven optimizers' ``init`` at full width, one layer (the
  expert stacks ``(1, E, 4096, F)``, the router 16 or 8 wide), on ``meta``
  tensors: the state's structure and bytes equal the reference's
  ``eval_shape`` count.
* Labels and B1 routes at full size (meta tensors): ``wo``, ``moe/w1``,
  ``moe/w2``, ``moe/w3`` fused, the router 4-bit and unfused.
* production4bit state bytes and q4 / bf16 serving weight bytes on the
  ``meta`` device against the reference's ``eval_shape`` counts, at full
  depth and at the depths the card runs (``chip_smoke.py``).

The structural byte counts are in ``tests/test_torch_moe_train.py``
(pytest-xdist's ``--dist loadfile`` hands out the files with the most tests first).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.core.optimizers import optimizer_names as j_optimizer_names  # noqa: E402
from repro.core.optimizers import state_nbytes as j_state_nbytes  # noqa: E402
from repro.core.optimizers.presets import production_labels as j_labels  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer, state_nbytes  # noqa: E402
from repro_torch.core.optimizers.presets import production_labels  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.io.tree import flatten_with_keys, structure_repr  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import init_model, named_params  # noqa: E402
from torch_ref import ref_params  # noqa: E402

torch.set_num_threads(1)

MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "mixtral-8x7b"]


def _cut(cfg, layers):
    return dataclasses.replace(cfg, num_layers=layers, blocks=cfg.blocks[:layers])


def _abstract_reference_state(name, jparams, steps):
    """The reference's state after ``steps`` updates, as shapes."""
    jopt = j_make(name, 1e-3)

    def run(p):
        s = jopt.init(p)
        for _ in range(steps):
            p, s = jopt.update(jax.tree_util.tree_map(jnp.ones_like, p), s, p)
        return s

    return jax.eval_shape(run, jparams)


@pytest.mark.parametrize("name", j_optimizer_names())
def test_optimizer_state_layout_on_reduced_phi35(name):
    """Two steps of the port from the reference's params; the state layout
    and bytes against the reference's after two updates."""
    arch = "phi3.5-moe-42b-a6.6b"
    jparams = ref_params(j_reduced(arch))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    opt = make_optimizer(name, 1e-3)
    ts = opt.init(tparams)
    rng = np.random.default_rng(0)
    for step in range(2):
        grads = {k: torch.from_numpy((rng.normal(size=p.shape) * 1e-2).astype(np.float32))
                 for k, p in tparams.items()}
        tparams, ts = opt.update(grads, ts, tparams, key=sr.fold_in(sr.PRNGKey(1), step))
    js = _abstract_reference_state(name, jparams, 2)
    assert structure_repr(ts) == str(jax.tree_util.tree_structure(js))
    tl = flatten_with_keys(ts)
    jl = jax.tree_util.tree_flatten_with_path(js)[0]
    assert [k for k, _ in tl] == [jax.tree_util.keystr(p) for p, _ in jl]
    for (k, a), (_, b) in zip(tl, jl):
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        assert tuple(a.shape) == tuple(b.shape), (k, tuple(a.shape), b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), (k, a.dtype, b.dtype)
    assert state_nbytes(ts) == j_state_nbytes(js)
    assert all(bool(torch.isfinite(p).all()) for p in tparams.values())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_width_state_of_every_optimizer(arch):
    jcfg = _cut(j_get_config(arch), 1)
    jparams = jax.eval_shape(lambda k: j_init(k, jcfg)[0], jax.random.PRNGKey(0))
    params = named_params(init_model(_cut(get_config(arch), 1), device="meta"))
    for name in j_optimizer_names():
        js = jax.eval_shape(lambda: j_make(name, 1e-3).init(jparams))
        ts = make_optimizer(name, 1e-3).init(params)
        assert structure_repr(ts) == str(jax.tree_util.tree_structure(js)), name
        assert state_nbytes(ts) == j_state_nbytes(js), name


# fused leaves (B1) per step at full size, by path within the sub
FUSED = {"decoder/0/sub0/attn/wo", "decoder/0/sub0/moe/w1", "decoder/0/sub0/moe/w2",
         "decoder/0/sub0/moe/w3"}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_size_labels_and_fused_routes(arch):
    """production4bit at full size on meta tensors: labels equal the
    reference's; B1 takes exactly the leaves the reference's
    ``FusedAdamWRoute.eligible`` takes; the router is 4-bit (no fp32 regex
    matches it) and unfused."""
    params = named_params(init_model(get_config(arch), device="meta"))
    labels, jlab = production_labels(), j_labels()
    labs = {k: labels(k, p) for k, p in params.items()}
    assert labs == {k: jlab(k, None) for k in params}
    fused = {k for k, p in params.items()
             if labs[k] == "4bit" and p.ndim >= 2 and p.shape[-1] % 256 == 0
             and p.numel() > 4096}
    assert fused == FUSED
    assert labs["decoder/0/sub0/moe/router"] == "4bit"  # a property of the reference
    state = make_optimizer("production4bit", 1e-3).init(params)
    m = state.states["4bit"].states[0].inner.m
    assert all(isinstance(m[k], QuantizedTensor) for k in fused)
    assert isinstance(m["decoder/0/sub0/moe/router"], QuantizedTensor)


# the reference's eval_shape counts: arch -> layers -> (production4bit state
# bytes, q4 weight bytes, bf16 weight bytes). 32 is full depth; the card
# trains phi3.5 at 5 layers and mixtral at 4 and serves them at 13 and 12
# (chip_smoke.py phases 21 and 23)
BYTES = {
    "phi3.5-moe-42b-a6.6b": {
        32: (45_013_580_376, 22_244_794_368, 83_745_062_912),
        3: (6_124_588_728, 2_211_924_736, 8_327_200_768),
        4: (7_465_588_440, 2_902_713_344, 10_927_816_704),
        5: (8_806_588_152, 3_593_501_952, 13_528_432_640),
        12: (18_193_586_136, 8_429_022_208, 31_732_744_192),
        13: (19_534_585_848, 9_119_810_816, 34_333_360_128),
    },
    "mixtral-8x7b": {
        32: (49_991_232_984, 24_810_872_832, 93_405_593_600),
        3: (6_587_528_760, 2_452_242_176, 9_231_925_248),
        4: (8_084_208_216, 3_223_229_440, 12_134_465_536),
        12: (20_057_643_864, 9_391_127_552, 35_354_787_840),
    },
}

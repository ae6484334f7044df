"""The optimizers of the port's last optimizer slice (``sm3``,
``adafactor``, ``factor4bit``) against the JAX reference run eagerly, and
the registry of all eleven names.

Identical params and grads go through both frameworks' ``init`` and
``update`` on a small tree of 2-d, 3-d, 1-d and 0-d leaves for four steps.
Every state leaf (keys in the reference's order, shapes, dtypes) is
compared: bit-equal where no reduction order enters (SM3's accumulators are
maxima; codes, scales and 1-d moments), within 1e-6 where a mean does
(``FactoredMoment`` rows and columns, Adafactor's RMS clipping and the
first moment after it) and where a square root does (SM3's first moment:
torch's CPU ``sqrt`` is not correctly rounded on its vector path, a few
elements in a thousand one ulp from numpy's and XLA's; CUDA's is).
"Within 1e-6" is 1e-6 of the element or of the leaf's largest magnitude: a
first moment ``b1 * m + (1 - b1) * u`` cancels, so one ulp of ``u`` is more
than 1e-6 of a small ``m``. Params within 1e-6 relative. The state bytes of
all eleven names are held to the reference's in ``tests/test_torch_optim.py``;
here, the one-layer cut that ``chip_smoke.py`` runs shampoo4bit at.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.optimizers import FactoredMoment as JFactoredMoment  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.core.optimizers import optimizer_names as j_optimizer_names  # noqa: E402
from repro.core.optimizers import state_nbytes as j_state_nbytes  # noqa: E402
from repro.core.quantizer import QuantizedTensor as JQ  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.optimizers import (  # noqa: E402
    FactoredMoment,
    make_optimizer,
    optimizer_names,
    state_nbytes,
)
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.io.tree import flatten_with_keys, structure_repr  # noqa: E402
from repro_torch.models import init_model, named_params  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-6


def small_tree():
    """A 2-d, a 3-d, a 1-d leaf above the 4096-element threshold, a small
    1-d and a 0-d leaf."""
    rng = np.random.default_rng(0)
    n = lambda *shape: (rng.normal(size=shape) * 0.02).astype(np.float32)
    return {"w2d": n(64, 96), "w3d": n(3, 40, 48), "v1d": n(5000), "b1d": n(32),
            "s0d": np.float32(0.5)}


def run_both(name, ov, steps, seed=1):
    """``steps`` eager updates of the reference and of the port from the
    same params and grads; returns (jax params, jax state, port params,
    port state)."""
    jparams = small_tree()
    tparams = params_from_jax(jparams, device="cpu")
    jopt, topt = j_make(name, 1e-3, **ov), make_optimizer(name, 1e-3, **ov)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    js, ts = jopt.init(jp), topt.init(tparams)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=np.shape(p)) * 1e-2).astype(np.float32), jparams)
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        tparams, ts = topt.update(params_from_jax(grads, device="cpu"), ts, tparams)
    return jp, js, tparams, ts


def jax_state_leaves(state):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]]


def port_state_leaves(state):
    return [(k, v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in flatten_with_keys(state)]


def assert_state_matches(ts, js, close_keys=()):
    """Same keys, shapes and dtypes; bit-equal, or within RTOL for leaves
    whose key holds one of ``close_keys``."""
    assert structure_repr(ts) == str(jax.tree_util.tree_structure(js))
    tl, jl = port_state_leaves(ts), jax_state_leaves(js)
    assert [k for k, _ in tl] == [k for k, _ in jl]
    for (k, a), (_, b) in zip(tl, jl):
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape, a.dtype, b.dtype)
        if any(s in k for s in close_keys):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max(), err_msg=k)
        else:
            np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                          b.reshape(-1).view(np.uint8), err_msg=k)


def assert_params_close(tparams, jp):
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for k, p in tparams.items():
        np.testing.assert_allclose(p.numpy(), jflat[k].numpy(), rtol=RTOL, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("name,ov,close_keys", [
    ("sm3", {}, (".m[",)),
    ("adafactor", {}, (".row", ".col", ".m[")),
    ("adafactor", {"b1": 0.0}, (".row", ".col")),
    ("factor4bit", {}, (".row", ".col")),
], ids=["sm3", "adafactor", "adafactor_b1_0", "factor4bit"])
def test_optimizer_matches_reference(name, ov, close_keys):
    jp, js, tparams, ts = run_both(name, ov, steps=4)
    assert_state_matches(ts, js, close_keys)
    assert state_nbytes(ts) == j_state_nbytes(js)
    assert_params_close(tparams, jp)
    assert make_optimizer(name, 1e-3, **ov).name == j_make(name, 1e-3, **ov).name


def test_sm3_accumulators_per_dim():
    """One vector per dim of each leaf; a 0-d param gets a (1,) one."""
    _, js, _, ts = run_both("sm3", {}, steps=1)
    acc = ts.states[0].acc
    assert [tuple(a.shape) for a in acc["w3d"]] == [(3,), (40,), (48,)]
    assert [tuple(a.shape) for a in acc["s0d"]] == [(1,)]
    assert [tuple(a.shape) for a in acc["v1d"]] == [(5000,)]


def test_adafactor_b1_zero_has_no_first_moment():
    ts = make_optimizer("adafactor", 1e-3, b1=0.0).init(params_from_jax(small_tree(),
                                                                        device="cpu"))
    inner = ts.states[0]
    assert inner.m is None
    assert isinstance(inner.v["w2d"], FactoredMoment) and inner.v["w2d"].row.shape == (64,)
    assert isinstance(inner.v["w3d"], FactoredMoment) and inner.v["w3d"].col.shape == (3, 48)
    assert not isinstance(inner.v["v1d"], FactoredMoment)


def test_factor4bit_state_structure():
    """m is B128/DE for leaves above the threshold; v is factored for
    ndim >= 2 (rows + cols, fp32) and 4-bit otherwise (the reference's
    ``test_factor4bit_state_structure``)."""
    params = params_from_jax({"w": np.zeros((64, 128), np.float32),
                              "b": np.zeros((8192,), np.float32)}, device="cpu")
    inner = make_optimizer("factor4bit", 1e-3).init(params).states[0].inner
    assert isinstance(inner.v["w"], FactoredMoment)
    assert inner.v["w"].nbytes() == (64 + 128) * 4
    assert isinstance(inner.v["b"], QuantizedTensor) and inner.v["b"].config.bits == 4
    assert isinstance(inner.m["w"], QuantizedTensor)
    assert inner.m["w"].config.normalization == "blockwise"
    jinner = j_make("factor4bit", 1e-3).init({"w": jnp.zeros((64, 128)),
                                              "b": jnp.zeros((8192,))}).states[0].inner
    assert isinstance(jinner.v["w"], JFactoredMoment) and isinstance(jinner.v["b"], JQ)
    assert structure_repr(inner) == str(jax.tree_util.tree_structure(jinner))


def test_registry_matches_reference():
    assert optimizer_names() == j_optimizer_names()
    assert len(optimizer_names()) == 11


def test_one_layer_shampoo4bit_state_bytes():
    """The count ``chip_smoke.py`` phase 11 holds its shampoo4bit run to:
    internlm2-1.8b at full width cut to its first layer, against the
    reference's ``eval_shape`` of the same cut."""
    import dataclasses

    from repro.configs import get_config as j_get_config

    jcfg = j_get_config("internlm2-1.8b")
    jcfg = dataclasses.replace(jcfg, num_layers=1, blocks=jcfg.blocks[:1])
    cfg = get_config("internlm2-1.8b")
    cfg = dataclasses.replace(cfg, num_layers=1, blocks=cfg.blocks[:1])
    js = jax.eval_shape(lambda: j_make("shampoo4bit", 1e-3).init(
        j_init(jax.random.PRNGKey(0), jcfg)[0]))
    params = named_params(init_model(cfg, device="meta"))
    got = state_nbytes(make_optimizer("shampoo4bit", 1e-3).init(params))
    assert got == j_state_nbytes(js) == 1_400_141_288

"""The optimizers on the port's recurrent archs (xlstm-125m, hymba-1.5b)
against the JAX reference: production4bit bit for bit, the full-size
routes, and the structural byte counts.

* The optimizer alone, eager on both sides (jitted JAX contracts FMAs, the
  port does not): three production4bit SR updates from the reference's
  params and the same seeded gradients, on small trees that take the
  full-size archs' routes: an xLSTM of width 256 (``w_in``, ``w_out``,
  ``w_gates`` as 256 slices of 4 x 256, and the sLSTM's ``w_out`` and
  ``mlp/w2`` through B1; ``wq``/``wk``/``wv``, the 5-D ``r_gates`` and the
  384-wide ``mlp/w1``/``w3`` 4-bit and unfused; ``w_if`` and ``b_if``
  under the 4096-element threshold) and a hymba of width 416 and 13 heads
  (nothing fused; ``ssm_dt`` a 3-D unfused leaf, as ``w_if`` is at full
  size, with an odd last dim and a size that is no multiple of 128). Every
  state leaf bit-equal (codes, scales, step counts, fp32 moments), params
  within 1e-6 relative, labels equal.
* Labels, B1 routes and the elements of each route at full size (meta
  tensors): xlstm-125m 11 fused leaves of 31,850,496 elements, 17,750,016
  unfused 4-bit, 77,279,232 fp32; hymba-1.5b none fused, 1,330,115,200
  unfused 4-bit (no last dim is a multiple of 256), 102,507,200 fp32;
  ``scale_attn``/``scale_ssm`` are 4-bit (no fp32 regex matches them).

(``tests/test_torch_recurrent_train.py`` holds the structural byte counts.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.core.optimizers.presets import production_labels as j_labels  # noqa: E402
from repro.core.optimizers.schedule import linear_warmup_linear_decay as j_sched  # noqa: E402
from repro.core.quantizer import QuantizedTensor as JQ  # noqa: E402
from repro.models import LayerSpec as JLayerSpec  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.core.optimizers.base import _leaves  # noqa: E402
from repro_torch.core.optimizers.presets import production_labels  # noqa: E402
from repro_torch.core.optimizers.schedule import linear_warmup_linear_decay  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import init_model, named_params  # noqa: E402

torch.set_num_threads(1)

RECURRENT_ARCHS = ["xlstm-125m", "hymba-1.5b"]


# ---------------------------------------------------------------------------
# the optimizer alone, bit for bit
# ---------------------------------------------------------------------------


def _jax_leaves(state):
    out = []
    for leaf in jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, JQ)):
        out += [leaf.codes, *leaf.scales] if isinstance(leaf, JQ) else [leaf]
    return [np.asarray(x) for x in out]


def _torch_leaves(state):
    out = []
    for leaf in _leaves(state):
        out += [leaf.codes, *leaf.scales] if isinstance(leaf, QuantizedTensor) else [leaf]
    return [x.detach().cpu().numpy() for x in out]


def _bits(a):
    return a.view(np.uint32) if a.dtype == np.float32 else a


# small trees with the full-size routes (see the module docstring)
MINI = {
    "xlstm": JModelConfig(name="xlstm-mini", num_layers=2, d_model=256, num_heads=4,
                          num_kv_heads=4, head_dim=64, d_ff=0, vocab_size=512,
                          blocks=(JLayerSpec("mlstm", 0), JLayerSpec("slstm", 0)), remat=False),
    # head_dim = ssm_state and d_ff = 2 * d_model, so that the leaves share
    # few shapes (eager JAX compiles every op for every new shape)
    "hymba": JModelConfig(name="hymba-mini", num_layers=1, d_model=416, num_heads=13,
                          num_kv_heads=13, head_dim=16, d_ff=832, vocab_size=512, ssm_state=16,
                          blocks=(JLayerSpec("hymba", 0),), remat=False),
}
MINI_FUSED = {
    "xlstm": {"decoder/0/sub0/w_in", "decoder/0/sub0/w_out", "decoder/1/sub0/w_gates",
              "decoder/1/sub0/w_out", "decoder/1/sub0/mlp/w2"},
    "hymba": set(),
}


@pytest.mark.parametrize("mini", list(MINI))
def test_production4bit_sr_updates_bit_equal(mini):
    jcfg = MINI[mini]
    jparams = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: j_init(k, jcfg)[0])(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jparams, device="cpu")
    jopt = j_make("production4bit", j_sched(1e-3, 1, 10))
    topt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 1, 10))
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    js, ts = jopt.init(jp), topt.init(tparams)
    rng = np.random.default_rng(1)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * 1e-2).astype(np.float32), jparams)
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp,
                             key=jax.random.fold_in(jax.random.PRNGKey(3), step))
        tparams, ts = topt.update(params_from_jax(grads, device="cpu"), ts, tparams,
                                  key=sr.fold_in(sr.PRNGKey(3), step))
    jl, tl = _jax_leaves(js), _torch_leaves(ts)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape, b.shape)
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"state leaf {i}")
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for k, p in tparams.items():
        np.testing.assert_allclose(p.numpy(), jflat[k].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    labels, jlab = production_labels(), j_labels()
    labs = {k: labels(k, p) for k, p in tparams.items()}
    assert labs == {k: jlab(k, None) for k in tparams}
    fused = {k for k, p in tparams.items() if labs[k] == "4bit" and p.ndim >= 2
             and p.shape[-1] % 256 == 0 and p.numel() > 4096}
    assert fused == MINI_FUSED[mini]
    four = ts.states["4bit"].states[0].inner
    if mini == "xlstm":
        rg = four.v["decoder/1/sub0/r_gates"]  # 5-D: one rank-1 stat per dim
        assert [tuple(s.shape) for s in rg.scales] == [(1,), (4,), (4,), (64,), (64,)]
        assert isinstance(four.m["decoder/0/sub0/wq"], QuantizedTensor)
    else:
        assert isinstance(four.m["decoder/0/sub0/ssm_dt"], QuantizedTensor)


# ---------------------------------------------------------------------------
# full size: labels, routes, structural bytes
# ---------------------------------------------------------------------------

FUSED = {
    "xlstm-125m": {f"decoder/0/sub{i}/{n}" for i in range(3) for n in ("w_in", "w_out")}
    | {f"decoder/0/sub3/{n}" for n in ("w_gates", "w_out", "mlp/w1", "mlp/w2", "mlp/w3")},
    "hymba-1.5b": set(),
}
# elements by route: (B1, unfused 4-bit, fp32-labeled)
ROUTE_ELEMENTS = {
    "xlstm-125m": (31_850_496, 17_750_016, 77_279_232),
    "hymba-1.5b": (0, 1_330_115_200, 102_507_200),
}


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_full_size_labels_and_fused_routes(arch):
    params = named_params(init_model(get_config(arch), device="meta"))
    labels, jlab = production_labels(), j_labels()
    labs = {k: labels(k, p) for k, p in params.items()}
    assert labs == {k: jlab(k, None) for k in params}
    fused = {k for k, p in params.items()
             if labs[k] == "4bit" and p.ndim >= 2 and p.shape[-1] % 256 == 0
             and p.numel() > 4096}
    assert fused == FUSED[arch]
    unfused = {k for k, p in params.items()
               if labs[k] == "4bit" and k not in fused and p.numel() > 4096}
    counts = tuple(sum(params[k].numel() for k in s) for s in (
        fused, unfused, {k for k in params if labs[k] == "fp32"}))
    assert counts == ROUTE_ELEMENTS[arch]
    state = make_optimizer("production4bit", 1e-3).init(params)
    m = state.states["4bit"].states[0].inner.m
    assert all(isinstance(m[k], QuantizedTensor) for k in fused | unfused)
    if arch == "hymba-1.5b":
        # properties of the reference: the output scales are 4-bit
        for name in ("scale_attn", "scale_ssm"):
            assert labs[f"decoder/1/sub0/{name}"] == "4bit"
        assert labs["decoder/1/sub0/norm1"] == "fp32"
        assert tuple(params["decoder/3/sub0/mlp/w1"].shape) == (15, 1600, 5504)

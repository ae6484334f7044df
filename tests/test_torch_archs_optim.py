"""production4bit's optimizer on the port's dense variants against the JAX
reference, bit for bit, and the structural byte counts at full size.

* The optimizer alone, eager on both sides (jitted JAX contracts FMAs, the
  port does not): each arch's reduced-config params (the reference's) and
  the same seeded gradients through two SR updates. Every state leaf (step
  counts, fused and unfused 4-bit codes and scales, fp32 moments)
  bit-equal, params within 1e-6 relative; the partition labels equal the
  reference's.
* production4bit state bytes and q4 / bf16 serving weight bytes at full
  size: the port's count on ``meta`` tensors equals the reference's
  ``jax.eval_shape`` count and the numbers written down for the card
  (``chip_smoke.py`` phases 15 and 17), at full depth and at the depths the
  card's training phase cuts to.
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
from repro.core.optimizers import state_nbytes as j_state_nbytes  # noqa: E402
from repro.core.optimizers.presets import production_labels as j_labels  # noqa: E402
from repro.core.optimizers.schedule import linear_warmup_linear_decay as j_sched  # noqa: E402
from repro.core.quantizer import QuantizedTensor as JQ  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serve import weight_report as j_weight_report  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer, state_nbytes  # noqa: E402
from repro_torch.core.optimizers.base import _leaves  # noqa: E402
from repro_torch.core.optimizers.presets import production_labels  # noqa: E402
from repro_torch.core.optimizers.schedule import linear_warmup_linear_decay  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import init_model, named_params  # noqa: E402
from repro_torch.serve import weight_report  # noqa: E402
from torch_ref import ref_params  # noqa: E402

torch.set_num_threads(1)

NEW_ARCHS = ["qwen3-4b", "chatglm3-6b", "gemma2-2b"]


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


def _jparams(arch):
    return ref_params(j_reduced(arch))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_optimizer_updates_bit_equal(arch):
    jparams = jax.tree_util.tree_map(np.asarray, _jparams(arch))
    tparams = params_from_jax(jparams, device="cpu")
    jopt = j_make("production4bit", j_sched(1e-3, 1, 10))
    topt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 1, 10))
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    js, ts = jopt.init(jp), topt.init(tparams)
    rng = np.random.default_rng(1)
    for step in range(2):
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
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{arch} state leaf {i}")
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for k, p in tparams.items():
        np.testing.assert_allclose(p.numpy(), jflat[k].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    # the 4-bit partition holds the unfused attention leaves and the fused
    # mlp leaves (d_ff 256), both compressed
    four = ts.states["4bit"].states[0].inner.m
    assert isinstance(four["decoder/0/sub0/attn/wq"], QuantizedTensor)
    assert isinstance(four["decoder/0/sub0/mlp/w1"], QuantizedTensor)
    labels, jlab = production_labels(), j_labels()
    assert {k: labels(k, p) for k, p in tparams.items()} == \
        {k: jlab(k, None) for k in tparams}


# full-size structural counts (the reference's eval_shape; chip_smoke.py
# holds the card's runs to them): arch -> (production4bit state bytes,
# q4 weight bytes, q4 leaves of all leaves, bf16 weight bytes)
FULL = {
    "qwen3-4b": (9_971_916_104, 2_343_578_016, (13, 14), 8_822_853_632),
    "chatglm3-6b": (10_152_562_232, 3_316_849_664, (11, 12), 12_486_918_144),
    "gemma2-2b": (6_807_623_456, 1_388_877_120, (23, 24), 5_228_688_384),
}
# the depths chip_smoke.py's training phase runs at, with the reference's
# production4bit state bytes there (and its probe depths, held to the
# reference's count alone)
CUTS = {"qwen3-4b": ((28, 9_138_936_936), (12, None)),
        "chatglm3-6b": ((9, 6_155_209_764), (4, None))}


def _cut(cfg, layers):
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers,
                                                          blocks=cfg.blocks[:layers])


def _state_bytes_both(arch, layers=None):
    jparams = jax.eval_shape(lambda k: j_init(k, _cut(j_get_config(arch), layers))[0],
                             jax.random.PRNGKey(0))
    jbytes = j_state_nbytes(jax.eval_shape(lambda: j_make("production4bit", 1e-3).init(jparams)))
    params = named_params(init_model(_cut(get_config(arch), layers), device="meta"))
    return state_nbytes(make_optimizer("production4bit", 1e-3).init(params)), jbytes, jparams, \
        params


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_size_bytes_match_reference(arch):
    mine, theirs, jparams, params = _state_bytes_both(arch)
    state_bytes, q4_bytes, (q4_leaves, n_leaves), bf16_bytes = FULL[arch]
    assert mine == theirs == state_bytes
    for mode, want in (("q4", q4_bytes), ("bf16", bf16_bytes)):
        t, j = weight_report(params, mode), j_weight_report(jparams, mode)
        assert t["total_serve_bytes"] == j["total_serve_bytes"] == want, mode
        assert [(r["path"], r["serve_bytes"]) for r in t["leaves"]] == \
            [(r["path"], r["serve_bytes"]) for r in j["leaves"]], mode
        if mode == "q4":
            assert (t["quantized_leaves"], t["n_leaves"]) == (q4_leaves, n_leaves)


@pytest.mark.parametrize("arch,layers,want", [(a, L, b) for a, cuts in CUTS.items()
                                              for L, b in cuts])
def test_cut_depth_state_bytes_match_reference(arch, layers, want):
    mine, theirs, _, _ = _state_bytes_both(arch, layers)
    assert mine == theirs
    assert want is None or mine == want

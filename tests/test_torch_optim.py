"""The port's optimizers against the JAX reference, and structural bytes.

Identical params, grads and SR key go through both frameworks' ``init`` and
``update`` on a small tree with one leaf of each route (kernel-eligible mlp
leaf, unfused attention leaf, fp32 embed/head/norm): every state leaf — step counts,
packed codes, scales, fp32 moments — must be bit-equal and params within
1e-6 relative. Byte counts of full-size trees are taken on meta tensors.

The structural state bytes are in ``tests/test_torch_stub_optim.py``
(pytest-xdist's ``--dist loadfile`` hands out the files with the most tests first).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.core.optimizers import optimizer_names as j_optimizer_names  # noqa: E402
from repro.core.optimizers import state_nbytes as j_state_nbytes  # noqa: E402
from repro.core.optimizers.schedule import linear_warmup_linear_decay as j_sched  # noqa: E402
from repro.core.quantizer import QuantizedTensor as JQ  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer, state_nbytes  # noqa: E402
from repro_torch.core.optimizers.base import _leaves  # noqa: E402
from repro_torch.core.optimizers.schedule import linear_warmup_linear_decay  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import LayerSpec, ModelConfig, init_model, named_params  # noqa: E402

torch.set_num_threads(1)


def _jax_leaves(state):
    out = []
    for leaf in jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, JQ)):
        if isinstance(leaf, JQ):
            out += [leaf.codes, *leaf.scales]
        else:
            out.append(leaf)
    return [np.asarray(x) for x in out]


def _torch_leaves(state):
    out = []
    for leaf in _leaves(state):
        if isinstance(leaf, QuantizedTensor):
            out += [leaf.codes, *leaf.scales]
        else:
            out.append(leaf)
    return [x.detach().cpu().numpy() for x in out]


def _bits(a):
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _small_tree():
    """One leaf of each route: fused (w1, last dim % 256 == 0), unfused 4-bit
    (wq), fp32 partition (embed, head, norm)."""
    rng = np.random.default_rng(0)
    n = lambda *shape: (rng.normal(size=shape) * 0.02).astype(np.float32)
    return {
        "decoder": [{"sub0": {
            "attn": {"wq": n(2, 64, 4, 16)},
            "mlp": {"w1": n(2, 64, 256)},
            "norm1": np.ones((2, 64), np.float32),
        }}],
        "embed": n(128, 64),
        "head": n(64, 128),
    }


@pytest.mark.parametrize("name,sr_seed", [
    ("production4bit", 3), ("production4bit", None), ("adamw4bit", None), ("adamw32", None),
])
def test_init_update_matches_reference(name, sr_seed):
    jparams = _small_tree()
    tparams = params_from_jax(jparams, device="cpu")
    jopt = j_make(name, j_sched(1e-3, 1, 10))
    topt = make_optimizer(name, linear_warmup_linear_decay(1e-3, 1, 10))
    js = jopt.init(jax.tree_util.tree_map(jnp.asarray, jparams))
    ts = topt.init(tparams)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    # eager on purpose: under jit XLA contracts b1*m + (1-b1)*g into a
    # fused multiply-add, which the port (like the reference's ops run
    # one by one) does not
    j_update = jopt.update
    rng = np.random.default_rng(1)
    for step in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * 1e-2).astype(np.float32), jparams
        )
        jkey = jax.random.fold_in(jax.random.PRNGKey(sr_seed), step) if sr_seed is not None else None
        tkey = sr.fold_in(sr.PRNGKey(sr_seed), step) if sr_seed is not None else None
        jp, js = j_update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp, key=jkey)
        tparams, ts = topt.update(params_from_jax(grads, device="cpu"), ts, tparams, key=tkey)
    jl, tl = _jax_leaves(js), _torch_leaves(ts)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"state leaf {i}")
    assert state_nbytes(ts) == j_state_nbytes(js)
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for k, p in tparams.items():
        np.testing.assert_allclose(p.numpy(), jflat[k].numpy(), rtol=1e-6, atol=1e-9, err_msg=k)


def _gpt2m_cfg():
    return ModelConfig(
        name="gpt2m-like", num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        head_dim=64, d_ff=4096, vocab_size=50257, blocks=(LayerSpec("dense", 0),) * 24,
        gated_mlp=False,
    )


@pytest.mark.parametrize("name", j_optimizer_names())
def test_reduced_state_bytes_match_reference(name):
    js = jax.eval_shape(lambda: j_make(name, 1e-3).init(
        j_init(jax.random.PRNGKey(0), j_reduced("internlm2-1.8b"))[0]))
    params = named_params(init_model(reduced_config("internlm2-1.8b"), device="meta"))
    assert state_nbytes(make_optimizer(name, 1e-3).init(params)) == j_state_nbytes(js)

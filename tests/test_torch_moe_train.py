"""production4bit on the port's MoE decoders (phi3.5-moe-42b-a6.6b,
mixtral-8x7b) against the JAX reference, on the CPU.

* The optimizer alone, eager on both sides (jitted JAX contracts FMAs, the
  port does not): three SR updates from the reference's params and the
  same seeded gradients, on a small MoE tree (16 experts, as phi3.5's)
  with every route of the full-size one: the ``(L, E, R, C)`` expert
  stacks through B1 (lead stats over ``(L, E)``), the router ``(L, D, E)``
  4-bit and unfused (its last dim, 16 or mixtral's 8, is no multiple of
  256), ``wq``/``wk``/``wv`` unfused, embed, head and norms fp32. Every
  state leaf bit-equal (codes, scales, step counts, fp32 moments), params
  within 1e-6 relative, labels equal.
* Three production4bit SR train steps per arch at ``reduced_config`` from
  the same params and batches, the jitted reference against the port:
  losses within 2e-3 relative (the per-arch loss tolerance of
  ``tests/test_torch_moe.py``: an expert choice may part at a bf16 near
  tie), aux losses within 1e-3.
* The training and q4 serving CLIs at CPU scale for each arch.

Also here: the structural byte counts of both MoE archs
(``tests/test_torch_moe_optim.py``'s cuts).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config, reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import (  # noqa: E402
    make_optimizer as j_make,
    state_nbytes as j_state_nbytes,
)
from repro.core.optimizers.presets import production_labels as j_labels  # noqa: E402
from repro.core.optimizers.schedule import linear_warmup_linear_decay as j_sched  # noqa: E402
from repro.core.quantizer import QuantizedTensor as JQ  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import (  # noqa: E402
    init_model as j_init,
    LayerSpec as JLayerSpec,
    ModelConfig as JModelConfig,
)
from repro.serve import weight_report as j_weight_report  # noqa: E402
from repro.train.train_loop import (  # noqa: E402
    build_train_step as j_build,
    make_train_state as j_make_state,
)
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import load_params, params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer, state_nbytes  # noqa: E402
from repro_torch.core.optimizers.base import _leaves  # noqa: E402
from repro_torch.core.optimizers.presets import production_labels  # noqa: E402
from repro_torch.core.optimizers.schedule import linear_warmup_linear_decay  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import init_model, named_params  # noqa: E402
from repro_torch.serve import weight_report  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402
from test_torch_moe_optim import _cut, BYTES  # noqa: E402
from torch_ref import ref_params  # noqa: E402

torch.set_num_threads(1)

MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "mixtral-8x7b"]


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


def _mini(experts):
    """A two-layer MoE decoder whose leaves take every route the full-size
    one does: d_model 256 (so ``wo``, ``w2`` fuse), router 2 x 256 x E above
    the 4096-element threshold."""
    return JModelConfig(name=f"moe-mini-{experts}", num_layers=2, d_model=256, num_heads=4,
                        num_kv_heads=2, head_dim=64, d_ff=256, vocab_size=512,
                        num_experts=experts, top_k=2, moe_group_size=64,
                        blocks=(JLayerSpec("moe", 0),) * 2, remat=False)


def test_production4bit_sr_updates_bit_equal():
    experts = 16
    jcfg = _mini(experts)
    jparams = jax.tree_util.tree_map(
        np.asarray, ref_params(jcfg))
    tparams = params_from_jax(jparams, device="cpu")
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * 1e-2).astype(np.float32), jparams)
        for _ in range(3)]

    def reference():
        jopt = j_make("production4bit", j_sched(1e-3, 1, 10))
        jp = jax.tree_util.tree_map(jnp.asarray, jparams)
        js = jopt.init(jp)
        for step, g in enumerate(grads):
            jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                                 key=jax.random.fold_in(jax.random.PRNGKey(3), step))
        return jp, js

    # the reference's eager steps (compiles, outside the GIL) beside the port's
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(reference)
        topt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 1, 10))
        ts = topt.init(tparams)
        for step, g in enumerate(grads):
            tparams, ts = topt.update(params_from_jax(g, device="cpu"), ts, tparams,
                                      key=sr.fold_in(sr.PRNGKey(3), step))
        jp, js = ref.result()
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
    four = ts.states["4bit"].states[0].inner
    pre = "decoder/0/sub0/"
    assert labs[pre + "moe/router"] == "4bit"
    for name in ("moe/router", "attn/wq", "moe/w1", "moe/w2", "moe/w3", "attn/wo"):
        assert isinstance(four.m[pre + name], QuantizedTensor), name
        assert four.v[pre + name].config.normalization == "rank1", name
    # the expert stacks' v keeps one stat per dim: (L,), (E,), rows, cols
    assert [tuple(s.shape) for s in four.v[pre + "moe/w1"].scales] == [(2,), (experts,),
                                                                       (256,), (256,)]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_steps_match_reference(arch):
    jcfg = j_reduced(arch)
    jparams = ref_params(jcfg)
    model = init_model(reduced_config(arch), device="cpu")
    load_params(model, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                       device="cpu"))
    steps = 3
    jopt = j_make("production4bit", j_sched(1e-3, 1, steps))
    topt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 1, steps))
    jstate = j_make_state(jparams, jopt, key=jax.random.PRNGKey(0))
    tstate = make_train_state(model, topt, key=sr.PRNGKey(0))
    jstep = jax.jit(j_build(jcfg, jopt))
    tstep = build_train_step(model, topt)
    data = SyntheticLM(DataConfig(512, 32, 4))
    jdata = JSyntheticLM(JDataConfig(512, 32, 4))
    for t in range(steps):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jdata.batch_at(t).items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in data.batch_at(t).items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-3)
        assert abs(float(tm["aux_loss"]) - float(jm["aux_loss"])) <= 1e-3
        assert float(tm["aux_loss"]) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cli_cpu_reduced_runs(arch, capsys):
    from repro_torch.launch import serve, train

    out = train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "32", "--optimizer", "production4bit",
                      "--sr-seed", "0"])
    assert len(out["steps"]) == 2
    assert all(np.isfinite(r["loss"]) and r["aux_loss"] > 0 for r in out["steps"])
    text = capsys.readouterr().out
    assert f"arch={arch}" in text and "aux_loss" in text
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--weights", "q4",
                      "--requests", "3", "--max-new-tokens", "4"])
    assert res["weight_report"]["quantized_leaves"] == 9  # reduced: the router stays fp32
    assert all(r.done and len(r.output) == 4 for r in res["requests"])


@pytest.mark.parametrize("arch,layers", [(a, L) for a, rows in BYTES.items() for L in rows])
def test_structural_bytes_match_reference(arch, layers):
    jparams = jax.eval_shape(lambda k: j_init(k, _cut(j_get_config(arch), layers))[0],
                             jax.random.PRNGKey(0))
    jbytes = j_state_nbytes(jax.eval_shape(lambda: j_make("production4bit", 1e-3).init(jparams)))
    params = named_params(init_model(_cut(get_config(arch), layers), device="meta"))
    mine = state_nbytes(make_optimizer("production4bit", 1e-3).init(params))
    state_bytes, q4_bytes, bf16_bytes = BYTES[arch][layers]
    assert mine == jbytes == state_bytes
    for mode, want in (("q4", q4_bytes), ("bf16", bf16_bytes)):
        t, j = weight_report(params, mode), j_weight_report(jparams, mode)
        assert t["total_serve_bytes"] == j["total_serve_bytes"] == want, mode
        assert [(r["path"], r["serve_bytes"]) for r in t["leaves"]] == \
            [(r["path"], r["serve_bytes"]) for r in j["leaves"]], mode
        if mode == "q4":
            assert (t["quantized_leaves"], t["n_leaves"]) == (12, 13)

"""Training the port's recurrent archs (xlstm-125m: mLSTM + sLSTM; hymba-1.5b:
attention + SSM heads) against the JAX reference, on the CPU.

(``tests/test_torch_recurrent_optim.py`` holds the optimizer alone bit for
bit, the full-size routes and the structural byte counts.)

* Loss and gradients at ``reduced_config`` from the reference's params:
  loss within 2e-4 relative, every gradient leaf within 3e-2 relative L2
  (bf16 products) but hymba's ``ssm_D``, within 1e-1: the reference sums
  its cotangent, a broadcast over (B, S, dh), in bf16, the port in fp32
  (``tests/test_torch_recurrent.py::test_reference_sums_bf16_cotangents_in_bf16``;
  measured 4.1e-2, against at most 1.2e-2 for the other leaves).
* Three production4bit SR train steps per arch at ``reduced_config``, the
  jitted reference against the port: losses within 2e-4 relative and
  gradient norms within 5e-3 (``tests/test_torch_train.py``'s tolerances).
* production4bit state bytes and q4 / bf16 serving weight bytes on the
  ``meta`` device against the reference's ``eval_shape`` counts (xlstm-125m
  669,510,744 / 67,447,776 / 253,784,352 B; hymba-1.5b 2,192,732,204 /
  761,193,920 / 2,865,315,200 B).
* The training and q4 serving CLIs at CPU scale for each arch.

Also here: ``gla_chunked`` against the reference
(``tests/test_torch_recurrent.py``'s bars).
"""

import dataclasses

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
from repro.core.optimizers.schedule import linear_warmup_linear_decay as j_sched  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import gla as j_gla, init_model as j_init, loss_fn as j_loss_fn  # noqa: E402
from repro.serve import weight_report as j_weight_report  # noqa: E402
from repro.train.train_loop import (  # noqa: E402
    build_train_step as j_build,
    make_train_state as j_make_state,
)
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import load_params, params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer, state_nbytes  # noqa: E402
from repro_torch.core.optimizers.schedule import linear_warmup_linear_decay  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import init_model, loss_fn, named_params  # noqa: E402
from repro_torch.models.gla import gla_chunked, GLAState  # noqa: E402
from repro_torch.serve import weight_report  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402
from test_models import naive_gla  # noqa: E402
from test_torch_recurrent import _close, _gla_inputs, _t  # noqa: E402
from torch_ref import ref_params  # noqa: E402

torch.set_num_threads(1)

RECURRENT_ARCHS = ["xlstm-125m", "hymba-1.5b"]


def _port_model(cfg, jparams):
    model = init_model(cfg, device="cpu")
    load_params(model, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                       device="cpu"))
    return model


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg = j_reduced(arch)
    jparams = ref_params(jcfg)
    model = _port_model(reduced_config(arch), jparams)
    b = SyntheticLM(DataConfig(512, 32, 4)).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(p, jcfg, b), has_aux=True))(
        jparams)
    tl, _ = loss_fn(model, {k: torch.from_numpy(v) for k, v in b.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-4)
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), device="cpu")
    mine = named_params(model)
    assert list(mine) == list(jflat)  # the reference's leaf order
    for k, p in mine.items():
        ref = jflat[k].numpy()
        err = np.linalg.norm(p.grad.numpy() - ref) / max(np.linalg.norm(ref), 1e-12)
        assert err < (1e-1 if k.endswith("/ssm_D") else 3e-2), (k, err)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_train_steps_match_reference(arch):
    jcfg = j_reduced(arch)
    jparams = ref_params(jcfg)
    model = _port_model(reduced_config(arch), jparams)
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
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=5e-3)


def _cut(cfg, layers):
    return dataclasses.replace(cfg, num_layers=layers, blocks=cfg.blocks[:layers])


# the reference's eval_shape counts: arch -> layers -> (production4bit state
# bytes, q4 weight bytes, q4 leaves, leaves, bf16 weight bytes)
BYTES = {
    "xlstm-125m": {12: (669_510_744, 67_447_776, 26, 35, 253_784_352)},
    "hymba-1.5b": {32: (2_192_732_204, 761_193_920, 70, 98, 2_865_315_200)},
}


@pytest.mark.parametrize("arch,layers", [(a, L) for a, rows in BYTES.items() for L in rows])
def test_structural_bytes_match_reference(arch, layers):
    jparams = jax.eval_shape(lambda k: j_init(k, _cut(j_get_config(arch), layers))[0],
                             jax.random.PRNGKey(0))
    jbytes = j_state_nbytes(jax.eval_shape(lambda: j_make("production4bit", 1e-3).init(jparams)))
    params = named_params(init_model(_cut(get_config(arch), layers), device="meta"))
    mine = state_nbytes(make_optimizer("production4bit", 1e-3).init(params))
    state_bytes, q4_bytes, q4_leaves, n_leaves, bf16_bytes = BYTES[arch][layers]
    assert mine == jbytes == state_bytes
    for mode, want in (("q4", q4_bytes), ("bf16", bf16_bytes)):
        t, j = weight_report(params, mode), j_weight_report(jparams, mode)
        assert t["total_serve_bytes"] == j["total_serve_bytes"] == want, mode
        assert [(r["path"], r["serve_bytes"]) for r in t["leaves"]] == \
            [(r["path"], r["serve_bytes"]) for r in j["leaves"]], mode
        if mode == "q4":
            assert (t["quantized_leaves"], t["n_leaves"]) == (q4_leaves, n_leaves)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_cli_cpu_reduced_runs(arch, capsys):
    from repro_torch.launch import serve, train

    out = train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "32", "--optimizer", "production4bit",
                      "--sr-seed", "0"])
    assert len(out["steps"]) == 2 and all(np.isfinite(r["loss"]) for r in out["steps"])
    assert f"arch={arch}" in capsys.readouterr().out
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--weights", "q4",
                      "--requests", "3", "--max-new-tokens", "4"])
    assert all(r.done and len(r.output) == 4 for r in res["requests"])
    assert res["weight_report"]["quantized_leaves"] > 0


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("S,chunk,init", [(37, 8, False), (64, 16, False), (21, 8, True)])
def test_gla_chunked_matches_reference(normalize, S, chunk, init):
    q, k, v, log_a, st = _gla_inputs(S, 1)
    jst = j_gla.GLAState(*(jnp.asarray(a) for a in st)) if init else None
    jy, jstate = jax.jit(lambda *a: j_gla.gla_chunked(*a, chunk=chunk, normalize=normalize,
                                                      init_state=jst))(q, k, v, log_a)
    ty, tstate = gla_chunked(_t(q), _t(k), _t(v), _t(log_a), chunk=chunk, normalize=normalize,
                             init_state=GLAState(*map(_t, st)) if init else None)
    assert ty.shape == (2, S, 3, 8) and ty.dtype == torch.float32
    _close(ty.numpy(), jy, what="y")
    for a, b in zip(tstate, jstate):
        _close(a.numpy(), b, what="state")
    if not init:
        np.testing.assert_allclose(ty.numpy(), naive_gla(q, k, v, log_a, normalize),
                                   rtol=2e-3, atol=2e-4)

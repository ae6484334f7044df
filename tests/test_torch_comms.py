"""The gradient wire formats of the port (``repro_torch.comms``) against the
reference's ``repro.comms``: the single-process cases of
``tests/test_comms.py``.

* ``CommsConfig``: parsing, properties, mapping validation;
* accounting: per-leaf bytes equal the real payload, reports equal the
  reference's, and the structural totals of GPT-2-M (int4 215,142,464 B
  against 1,619,865,600 B fp32) and internlm2-1.8b (all four modes);
* ``reduce_grads`` without a mesh: fp32 passes through, bf16 casts bit for
  bit, int8/int4 transport codes and scales bit-equal to the reference's
  (round to nearest, and stochastic rounding from the same key), outputs
  bit-equal; ``grad_comm_key`` equals the reference's key;
* the train step with ``comms=``: three reduced production4bit SR steps
  against the reference's jitted step, losses within 2e-4 relative and
  gradient norms within 5e-3 (the tolerances of ``test_torch_train.py``;
  the bf16 products round at other places, which can move a transport
  code); the CLI's wire line and both SR warnings; a mesh refused.

``CommsConfig``, the accounting and ``reduce_grads``' threshold and RTN
cases are in ``tests/test_torch_mesh_comms.py`` (pytest-xdist's ``--dist
loadfile`` hands out the files with the most tests first).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comms import CommsConfig as JCommsConfig  # noqa: E402
from repro.comms import grad_comm_key as j_grad_comm_key  # noqa: E402
from repro.comms import reduce_grads as j_reduce_grads  # noqa: E402
from repro.comms import wire_report as j_wire_report  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.core.optimizers.schedule import linear_warmup_linear_decay as j_sched  # noqa: E402
from repro.core.quantizer import quantize as j_quantize  # noqa: E402
from repro.kernels import sr as j_sr  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.train.train_loop import build_train_step as j_build  # noqa: E402
from repro.train.train_loop import make_train_state as j_make_state  # noqa: E402
from repro_torch.comms import (  # noqa: E402
    CommsConfig,
    grad_comm_key,
    quantized_all_reduce,
    reduce_grads,
    wire_report,
)
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import load_params, params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.core.optimizers.schedule import linear_warmup_linear_decay  # noqa: E402
from repro_torch.core.quantizer import dequantize, quantize  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import init_model, named_params  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402

torch.set_num_threads(1)


def _grads_np():
    rng = np.random.default_rng(0)
    return {"embed": rng.standard_normal((256, 64), dtype=np.float32),
            "w": rng.standard_normal((128, 128), dtype=np.float32),
            "bias": rng.standard_normal((64,), dtype=np.float32)}


def _grads():
    return {k: torch.from_numpy(v) for k, v in _grads_np().items()}


def _jgrads():
    return {k: jnp.asarray(v) for k, v in _grads_np().items()}


def _bits(x):
    x = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
    return x.reshape(-1).view(np.uint32)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,wire,quantized", [
    ("fp32", 7_556_440_064, 0), ("bf16", 3_778_220_032, 0),
    ("int8", 1_948_150_784, 11), ("int4", 1_003_596_800, 11),
])
def test_wire_report_internlm2(mode, wire, quantized):
    params = named_params(init_model(get_config("internlm2-1.8b"), device="meta"))
    r = wire_report(params, CommsConfig(mode=mode))
    jparams = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0),
                                            j_get_config("internlm2-1.8b"))[0])
    assert r["total_wire_bytes"] == j_wire_report(jparams, JCommsConfig(mode=mode))[
        "total_wire_bytes"] == wire
    assert r["quantized_leaves"] == quantized and r["n_leaves"] == 12


# ---------------------------------------------------------------------------
# reduce_grads numerics
# ---------------------------------------------------------------------------


def test_reduce_grads_fp32_and_bf16_modes():
    grads = _grads()
    out = reduce_grads(grads, None, None, CommsConfig())
    for k in grads:
        assert torch.equal(out[k], grads[k])
    out = reduce_grads(grads, None, None, CommsConfig(mode="bf16"))
    jout = j_reduce_grads(_jgrads(), None, None, JCommsConfig(mode="bf16"))
    for k in grads:
        assert out[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(out[k]), _bits(jout[k]))


def test_grad_comm_key_stream():
    assert grad_comm_key(None, 3) is None
    base = sr.PRNGKey(7)
    k3 = grad_comm_key(base, 3)
    jk3 = j_grad_comm_key(jax.random.PRNGKey(7), jnp.int32(3))
    assert k3 == tuple(int(w) for w in np.asarray(jax.random.key_data(jk3)))
    assert grad_comm_key(base, 3) == k3 != grad_comm_key(base, 4)
    assert k3 != sr.fold_in(base, 3)  # apart from the optimizer's per-step key


@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("use_sr", [False, True], ids=["rtn", "sr"])
def test_transport_bit_equal_to_reference(mode, use_sr):
    """Codes and scales of every quantized leaf, and the reduced tree, equal
    the reference's for the same key (round to nearest without one)."""
    cfg, jcfg = CommsConfig(mode=mode), JCommsConfig(mode=mode)
    key = grad_comm_key(sr.PRNGKey(5), 2) if use_sr else None
    jkey = j_grad_comm_key(jax.random.PRNGKey(5), jnp.int32(2)) if use_sr else None
    grads, jgrads = _grads(), _jgrads()
    for i, k in enumerate(sorted(grads)):  # the reference's leaf order
        if grads[k].numel() <= cfg.threshold:
            continue
        u = sr.tensor_uniforms(sr.fold_in(key, i), tuple(grads[k].shape), sr.STREAM_GRAD,
                               "cpu") if use_sr else None
        ju = j_sr.tensor_uniforms(jax.random.fold_in(jkey, i), jgrads[k].shape,
                                  j_sr.STREAM_GRAD) if use_sr else None
        q = quantize(grads[k], cfg.quant_config(), uniforms=u)
        jq = j_quantize(jgrads[k], jcfg.quant_config(), uniforms=ju)
        np.testing.assert_array_equal(q.codes.numpy(), np.asarray(jq.codes), err_msg=k)
        np.testing.assert_array_equal(_bits(q.scales[0]), _bits(jq.scales[0]), err_msg=k)
    out = reduce_grads(grads, None, None, cfg, key=key)
    jout = j_reduce_grads(jgrads, None, None, jcfg, key=jkey)
    for k in grads:
        np.testing.assert_array_equal(_bits(out[k]), _bits(jout[k]), err_msg=k)


def test_quantized_all_reduce_one_rank_and_mesh_context(tmp_path):
    """One gloo rank: the wire primitive is its own rank's transport
    quantization (``fold_in(key, 0)`` on STREAM_GRAD); the mesh path of
    ``reduce_grads`` needs the mesh context (the worlds of several ranks are
    ``tests/test_torch_mesh_comms.py``)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        qcfg = CommsConfig(mode="int4").quant_config()
        x = _grads()["w"]
        key = sr.PRNGKey(3)
        u = sr.tensor_uniforms(sr.fold_in(key, 0), tuple(x.shape), sr.STREAM_GRAD, "cpu")
        want = dequantize(quantize(x, qcfg, uniforms=u))
        assert torch.equal(quantized_all_reduce(x, qcfg, None, key=key), want)
        assert torch.equal(quantized_all_reduce(x, qcfg), dequantize(quantize(x, qcfg)))
        with pytest.raises(ValueError, match="no mesh context"):
            reduce_grads(_grads(), {"w": ("embed", "mlp")}, {"data": 1, "model": 1},
                         CommsConfig(mode="int4"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the train step and the CLI
# ---------------------------------------------------------------------------


def _batch(step):
    return SyntheticLM(DataConfig(512, 32, 4)).batch_at(step)


@pytest.mark.parametrize("mode", ["bf16", "int4"])
def test_train_steps_with_comms_match_reference(mode):
    from repro.comms import CommsConfig as JC

    jcfg = j_reduced("internlm2-1.8b")
    jparams, _ = j_init(jax.random.PRNGKey(0), jcfg)
    model = init_model(reduced_config("internlm2-1.8b"), device="cpu")
    load_params(model, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    steps = 3
    jopt = j_make("production4bit", j_sched(1e-3, 1, steps))
    topt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 1, steps))
    jstate = j_make_state(jparams, jopt, key=jax.random.PRNGKey(0))
    tstate = make_train_state(model, topt, key=sr.PRNGKey(0))
    jstep = jax.jit(j_build(jcfg, jopt, comms=JC(mode=mode)))
    tstep = build_train_step(model, topt, comms=CommsConfig(mode=mode))
    for t in range(steps):
        b = _batch(t)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=5e-3)


def test_int4_comms_training_moves_loss_single_process():
    """int4 transport trains the reduced LM to a loss close to the fp32
    run's (the reference's ``test_int4_comms_training_moves_loss``)."""
    losses = {}
    for mode in ("fp32", "int4"):
        model = init_model(reduced_config("internlm2-1.8b"), seed=0, device="cpu")
        opt = make_optimizer("adamw32", 3e-3)
        state = make_train_state(model, opt, key=sr.PRNGKey(5))
        step = build_train_step(model, opt, comms=CommsConfig(mode=mode))
        for t in range(12):
            state, metrics = step(state, {k: torch.from_numpy(v) for k, v in _batch(t).items()})
        losses[mode] = float(metrics["loss"])
    assert np.isfinite(losses["int4"])
    assert losses["int4"] < np.log(512)
    assert abs(losses["int4"] - losses["fp32"]) < 0.3


CLI = ["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu", "--steps", "1",
       "--batch", "2", "--seq", "16"]
WARN_OPT = "optimizer is configured for stochastic rounding but no --sr-seed"
WARN_COMM = "--grad-comm int4 transports gradients with stochastic rounding but no --sr-seed"


@pytest.mark.parametrize("opt,seed,warnings", [
    ("production4bit", None, (WARN_OPT, WARN_COMM)),
    ("adamw32", None, (WARN_COMM,)),
    ("production4bit", "0", ()),
], ids=["both", "transport_only", "seeded"])
def test_cli_grad_comm_line_and_warnings(opt, seed, warnings, capsys):
    args = CLI + ["--optimizer", opt, "--grad-comm", "int4"]
    out = train.main(args + (["--sr-seed", seed] if seed else []))
    text = capsys.readouterr().out
    wire = out["wire"]
    assert (f"grad-comm=int4/B128/DE+SR collective_bytes/step={wire['total_wire_bytes']:,} "
            f"({wire['ratio_vs_fp32']:.2f}x fewer than fp32, "
            f"{wire['quantized_leaves']}/{wire['n_leaves']} leaves quantized)") in text
    for w in (WARN_OPT, WARN_COMM):
        assert (w in text) == (w in warnings), w
    assert np.isfinite(out["steps"][0]["loss"])

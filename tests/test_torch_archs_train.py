"""production4bit on the port's dense variants (qwen3-4b, chatglm3-6b,
gemma2-2b) against the JAX reference, on the CPU.

(``tests/test_torch_archs_optim.py`` holds the optimizer alone bit for bit.)

* Three production4bit SR train steps from the same params and batches:
  losses within 2e-4 relative and gradient norms within 5e-3
  (``tests/test_torch_train.py``'s tolerances), the jitted reference
  against the port.
* Labels and B1 routes at full size (meta tensors): gemma2's sandwich-norm
  scales ``post1``/``post2`` take the 4-bit partition (the reference's fp32
  regexes do not match them) and B1, as one slice of 13 rows; the fused
  leaf counts are 18 / 4 / 2 (gemma2 / qwen3 / chatglm3).
* The CLI at CPU scale for each arch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.core.optimizers.presets import production_labels as j_labels  # noqa: E402
from repro.core.optimizers.schedule import linear_warmup_linear_decay as j_sched  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.train.train_loop import build_train_step as j_build  # noqa: E402
from repro.train.train_loop import make_train_state as j_make_state  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import load_params, params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.core.optimizers.presets import production_labels  # noqa: E402
from repro_torch.core.optimizers.schedule import linear_warmup_linear_decay  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import init_model, named_params  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402
from torch_ref import ref_params  # noqa: E402

torch.set_num_threads(1)

NEW_ARCHS = ["qwen3-4b", "chatglm3-6b", "gemma2-2b"]


def _jparams(arch):
    return ref_params(j_reduced(arch))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_steps_match_reference(arch):
    jcfg = j_reduced(arch)
    jparams = _jparams(arch)
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
        b = data.batch_at(t)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jdata.batch_at(t).items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=5e-3)


# fused leaves (B1) per step at full size, by path within a sub
FUSED = {
    "gemma2-2b": {f"decoder/0/{s}/{n}" for s in ("sub0", "sub1")
                  for n in ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w1", "mlp/w2",
                            "mlp/w3", "post1", "post2")},
    "qwen3-4b": {"decoder/0/sub0/attn/wo", "decoder/0/sub0/mlp/w1", "decoder/0/sub0/mlp/w2",
                 "decoder/0/sub0/mlp/w3"},
    "chatglm3-6b": {"decoder/0/sub0/attn/wo", "decoder/0/sub0/mlp/w2"},
}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_size_labels_and_fused_routes(arch):
    """production4bit at full size on meta tensors: labels equal the
    reference's, and B1 takes exactly the leaves the reference's
    ``FusedAdamWRoute.eligible`` takes (ndim >= 2, last dim % 256 == 0, in
    the 4-bit partition)."""
    params = named_params(init_model(get_config(arch), device="meta"))
    labels, jlab = production_labels(), j_labels()
    labs = {k: labels(k, p) for k, p in params.items()}
    assert labs == {k: jlab(k, None) for k in params}
    fused = {k for k, p in params.items()
             if labs[k] == "4bit" and p.ndim >= 2 and p.shape[-1] % 256 == 0
             and p.numel() > 4096}
    assert fused == FUSED[arch]
    if arch == "gemma2-2b":
        assert labs["decoder/0/sub0/post1"] == "4bit"  # a property of the reference
        assert labs["decoder/0/sub0/norm1"] == "fp32" and labs["embed"] == "fp32"
    if arch == "qwen3-4b":
        assert labs["decoder/0/sub0/attn/q_norm"] == "fp32"
    state = make_optimizer("production4bit", 1e-3).init(params)
    m = state.states["4bit"].states[0].inner.m
    assert all(isinstance(m[k], QuantizedTensor) for k in fused)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cli_cpu_reduced_run(arch, capsys):
    from repro_torch.launch import train

    out = train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--optimizer", "production4bit",
                      "--sr-seed", "0"])
    assert len(out["steps"]) == 2 and all(np.isfinite(r["loss"]) for r in out["steps"])
    assert f"arch={arch}" in capsys.readouterr().out

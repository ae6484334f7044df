"""Checkpoints crossing between the port and the reference: the port's
restored by the reference and the reference's by the port, optimizer by
optimizer, bit for bit with validation on (``tests/test_torch_io.py``'s
helpers; see its docstring).

Also here: npz checkpoints written by either package read by the port."""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.io import restore_checkpoint as j_restore, save_checkpoint as j_save  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.train.train_loop import make_train_state as j_make_state  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.io import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402
from test_torch_io import (  # noqa: E402
    _j_nonzero_state,
    _nonzero_state,
    _target_of,
    assert_leaves_equal,
    cfgs,
    jax_leaves,
    port_leaves,
    port_model,
    restore_port,
    tbatch,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("name,ov", [
    ("production4bit", {}),
    ("adamw4bit", {"stochastic_rounding": True, "use_kernel": True}),
    ("sgdm4bit", {}),
    ("factor4bit", {}),
    ("adafactor", {}),
    ("adafactor", {"b1": 0.0}),
    ("sm3", {}),
    ("shampoo32", {}),
    ("shampoo4bit", {"stochastic_rounding": True}),
], ids=["production4bit", "adamw4bit_sr_kernel", "sgdm4bit", "factor4bit", "adafactor",
        "adafactor_b1_0", "sm3", "shampoo32", "shampoo4bit_sr"])
def test_port_checkpoint_restores_in_jax(name, ov, tmp_path):
    """The port trains 3 steps and saves; the reference's own
    restore_checkpoint (validation on) into its abstract state gives the
    port's leaves bit for bit."""
    jcfg, cfg = cfgs(256)
    jparams, _ = j_init(jax.random.PRNGKey(0), jcfg)
    model = port_model(cfg, jparams)
    opt = make_optimizer(name, 3e-3, **ov)
    state = make_train_state(model, opt, key=sr.PRNGKey(17))
    step = build_train_step(model, opt)
    for t in range(3):
        state, _ = step(state, tbatch(t))
    d = str(tmp_path / "c")
    save_checkpoint(d, 3, state)
    jopt = j_make(name, 3e-3, **ov)
    target = jax.eval_shape(lambda: j_make_state(jparams, jopt, key=jax.random.PRNGKey(17)))
    restored, _ = j_restore(d, target)
    assert_leaves_equal(jax_leaves(restored), port_leaves(state), "port -> JAX @3")


@pytest.mark.parametrize("name,ov", [
    ("factor4bit", {}), ("adafactor", {}), ("adafactor", {"b1": 0.0}), ("sm3", {}),
    ("shampoo32", {}), ("shampoo4bit", {}),
], ids=["factor4bit", "adafactor", "adafactor_b1_0", "sm3", "shampoo32", "shampoo4bit"])
def test_jax_checkpoint_restores_in_port(name, ov, tmp_path):
    """The reference's state after two updates, saved by the reference,
    restores in the port (validation on) bit for bit."""
    jstate, _, cfg = _j_nonzero_state(name, **ov)
    d = str(tmp_path / "c")
    j_save(d, 2, jstate)
    _, _, state = restore_port(d, cfg, name, ov, sr.PRNGKey(5))
    assert_leaves_equal(port_leaves(state), jax_leaves(jstate), f"JAX -> port: {name}")


def test_legacy_npz_written_by_port_readable(tmp_path):
    state, cfg = _nonzero_state("adamw4bit")
    d = str(tmp_path / "c")
    save_checkpoint(d, 4, state, fmt_version="npz")
    assert not os.path.exists(os.path.join(d, "step_00000004", "COMMIT"))
    assert latest_step(d) == 4
    restored, _ = restore_checkpoint(d, _target_of(state, cfg, "adamw4bit"), device="cpu")
    assert_leaves_equal(port_leaves(restored), port_leaves(state), "port npz")


def test_legacy_npz_written_by_jax_readable(tmp_path):
    jstate, _, cfg = _j_nonzero_state("adamw4bit")
    d = str(tmp_path / "c")
    j_save(d, 4, jstate, fmt_version="npz")
    assert latest_step(d) == 4
    _, _, state = restore_port(d, cfg, "adamw4bit", {}, sr.PRNGKey(5))
    assert_leaves_equal(port_leaves(state), jax_leaves(jstate), "JAX npz")

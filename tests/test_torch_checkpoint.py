"""Save -> restore -> continue inside the port, bit for bit; the optimizers
that came with the checkpoints (``sgdm``, ``sgdm4bit``, ``adamw8bit``)
against the reference; ``migrate_legacy_state``; crash recovery through
``checkpoint_hooks``/``run_with_recovery``; and the train CLI's resume.

Ports of the single-device cases of ``tests/test_checkpoint_roundtrip.py``
and ``tests/test_checkpoint_crash.py``. Bit-equality against the reference
runs it eagerly (jitted JAX contracts FMAs, the port does not).

The newer optimizers, ``migrate_legacy_state``, the recovery cases and
the abstract state are in ``tests/test_torch_checkpoint_migrate.py``
(pytest-xdist's ``--dist loadfile`` hands out the files with the most tests first).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.convert import serving_params_from_jax  # noqa: E402
from repro.core.optimizers import FactoredMoment as JFactoredMoment  # noqa: E402
from repro_torch.core.optimizers import FactoredMoment, make_optimizer  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.io import save_checkpoint  # noqa: E402
from repro_torch.io import format as ckfmt  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402
from test_torch_io import (  # noqa: E402
    OPT_IDS,
    OPTIMIZERS,
    assert_leaves_equal,
    cfgs,
    port_leaves,
    restore_port,
    tbatch,
)

torch.set_num_threads(1)


def _bits(a):
    return a.reshape(-1).view(np.uint8)


# ---------------------------------------------------------------------------
# (d) save -> restore -> continue == uninterrupted, every leaf
# ---------------------------------------------------------------------------


def _roundtrip(cfg, name, ov, tmp_path):
    opt = make_optimizer(name, 3e-3, **ov)
    model = init_model(cfg, device="cpu")
    key = sr.PRNGKey(5)  # harmless for RTN optimizers, load-bearing for SR
    state = make_train_state(model, opt, key=key)
    step = build_train_step(model, opt)
    for t in range(3):
        state, _ = step(state, tbatch(t))
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 3, state)
    saved = port_leaves(state)  # host copies: the params change in place below
    for t in range(3, 6):
        state, _ = step(state, tbatch(t))

    # restore on a "fresh process": an abstract target, nothing reused
    model2, opt2, restored = restore_port(d, cfg, name, ov, key)
    assert_leaves_equal(port_leaves(restored), saved, f"{name}: restored @3")
    step2 = build_train_step(model2, opt2)
    for t in range(3, 6):
        restored, _ = step2(restored, tbatch(t))
    assert_leaves_equal(port_leaves(restored), port_leaves(state),
                        f"{name}: resumed vs uninterrupted @6")
    return restored


@pytest.mark.parametrize("name,ov", OPTIMIZERS, ids=OPT_IDS)
def test_roundtrip_bit_identical_all_optimizers(name, ov, tmp_path):
    _roundtrip(cfgs(128)[1], name, ov, tmp_path)


@pytest.mark.parametrize("name,ov", [
    ("production4bit", {}),
    ("adamw4bit", {"stochastic_rounding": True, "use_kernel": True}),
], ids=["production4bit", "adamw4bit_sr_kernel"])
def test_roundtrip_bit_identical_fused_sr_path(name, ov, tmp_path):
    """Through the fused SR route (its plain version on the CPU): the
    per-step key is a pure function of (base key, step), the in-kernel
    noise of (leaf key, element), so the resumed run redraws it exactly."""
    from repro_torch.core.optimizers.transform import FusedAdamWRoute

    restored = _roundtrip(cfgs(256)[1], name, ov, tmp_path)
    opt_state = restored.opt_state
    chain = opt_state.states["4bit"] if name == "production4bit" else opt_state
    inner = chain.states[0].inner
    m_leaf, v_leaf = inner.m["decoder/0/sub0/mlp/w1"], inner.v["decoder/0/sub0/mlp/w1"]
    assert isinstance(m_leaf, QuantizedTensor) and m_leaf.config.stochastic_rounding
    assert FusedAdamWRoute(lr=3e-3).eligible({"m": m_leaf, "v": v_leaf},
                                             restored.params["decoder/0/sub0/mlp/w1"])


# ---------------------------------------------------------------------------
# (k) the optimizers that came with the checkpoints, against eager JAX
# ---------------------------------------------------------------------------


def _small_tree():
    rng = np.random.default_rng(0)
    n = lambda *shape: (rng.normal(size=shape) * 0.02).astype(np.float32)
    return {"decoder": [{"sub0": {"attn": {"wq": n(2, 64, 4, 16)}, "mlp": {"w1": n(2, 64, 1024)},
                                  "norm1": np.ones((2, 64), np.float32)}}],
            "embed": n(256, 64), "head": n(64, 128)}


def _jax_state_leaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


# ---------------------------------------------------------------------------
# (h) legacy dict-state migration
# ---------------------------------------------------------------------------


def _legacy_params():
    rng = np.random.default_rng(3)
    f32 = lambda a: a.astype(np.float32)
    return {"embed": f32(rng.normal(size=(64, 256)) * 0.1),
            "w": f32(rng.normal(size=(16, 512)) * 0.1),
            "bias": f32(rng.normal(size=(64,)) * 0.1)}


def _legacy_grads(t, params):
    rng = np.random.default_rng(100 + t)
    return {k: (rng.normal(size=p.shape) * 0.02).astype(np.float32) for k, p in params.items()}


def _to_port(tree):
    """A legacy JAX moment tree -> the port's {path: tensor or QuantizedTensor}."""
    return serving_params_from_jax(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _legacy_state_to_port(s):
    out = {k: _to_port(v) for k, v in s.items() if k != "step"}
    out["step"] = int(s["step"])
    return out


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_moment_equal(tmoment, jmoment, what):
    assert_leaves_equal(port_leaves(tmoment), port_leaves(_to_port(jmoment)), what)


def _legacy_factored_to_port(s):
    """A legacy state whose v holds the reference's ``FactoredMoment``s."""
    out = {"m": _to_port(s["m"]), "step": int(s["step"])}
    out["v"] = {k: FactoredMoment(torch.from_numpy(np.array(v.row)),
                                  torch.from_numpy(np.array(v.col)), v.shape)
                if isinstance(v, JFactoredMoment) else torch.from_numpy(np.array(v))
                for k, v in sorted(s["v"].items())}
    return out


# ---------------------------------------------------------------------------
# (i) crash recovery (tests/test_checkpoint_crash.py)
# ---------------------------------------------------------------------------


def _meta_target(holder):
    return lambda: {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                    for k, v in holder["state"].items()}


def _corrupt_midwrite(directory, step):
    """A save killed between shard write and COMMIT: marker gone, shard cut."""
    d = ckfmt.step_dir(directory, step)
    os.remove(os.path.join(d, ckfmt.COMMIT))
    bin_path = os.path.join(d, ckfmt.shard_file(0))
    with open(bin_path, "r+b") as f:
        f.truncate(os.path.getsize(bin_path) // 2)


# ---------------------------------------------------------------------------
# (j) the train CLI's save and resume
# ---------------------------------------------------------------------------

CLI = ["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu", "--steps", "5",
       "--batch", "2", "--seq", "16", "--optimizer", "production4bit", "--sr-seed", "0"]


def test_cli_resume_is_bit_identical(tmp_path, capsys):
    """5 steps saving at step 3, then a rerun: it resumes from 3, runs steps
    3 and 4 only, and ends bit-equal to one uninterrupted run."""
    d = str(tmp_path / "ckpt")
    ck = ["--ckpt-dir", d, "--ckpt-every", "3", "--keep-last", "1"]
    plain = train.main(CLI)
    first = train.main(CLI + ck)
    assert first["checkpoint"]["resumed_from"] == 0
    assert [s["step"] for s in first["checkpoint"]["saves"]] == [3]
    assert first["checkpoint"]["saves"][0]["commit_s"] >= 0
    assert ckfmt.latest_step(d) == 3 and ckfmt.list_steps(d) == [3]
    m = ckfmt.read_manifest(ckfmt.step_dir(d, 3))
    assert m["format_version"] == 2 and m["step"] == 3
    nbytes = sum(int(np.prod(x["shape"], dtype=np.int64)) * ckfmt.dtype_from_str(x["dtype"]).itemsize
                 for x in m["leaves"])
    assert os.path.getsize(os.path.join(ckfmt.step_dir(d, 3), ckfmt.shard_file(0))) == nbytes
    second = train.main(CLI + ck)
    assert "resumed from step 3" in capsys.readouterr().out
    assert second["checkpoint"]["resumed_from"] == 3
    assert [r["step"] for r in second["steps"]] == [3, 4]
    assert [r["loss"] for r in second["steps"]] == [r["loss"] for r in plain["steps"][3:]]
    assert [r["loss"] for r in first["steps"]] == [r["loss"] for r in plain["steps"]]
    assert_leaves_equal(port_leaves(second["state"]), port_leaves(plain["state"]), "CLI resume")


def test_cli_refuses_ckpt_every_0(capsys):
    """--ckpt-every must be at least 1."""
    with pytest.raises(SystemExit):
        train.main(CLI + ["--ckpt-dir", "x", "--ckpt-every", "0"])
    assert "--ckpt-every" in capsys.readouterr().err

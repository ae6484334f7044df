"""Checkpoints of the newer optimizers against the reference's, the
migration of legacy optimizer states, and recovery around failed or
uncommitted saves (``tests/test_torch_checkpoint.py``'s helpers; see its
docstring)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from legacy_optimizers import legacy_quantized_adamw, legacy_sgdm4bit  # noqa: E402
import numpy as np  # noqa: E402
from repro.core.optimizers import (  # noqa: E402
    make_optimizer as j_make,
    QuantPolicy as JQuantPolicy,
)
from repro.core.optimizers.adamw import M_4BIT as J_M_4BIT, V_4BIT as J_V_4BIT  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.optimizers import (  # noqa: E402
    adamw4bit,
    adamw8bit,
    factor4bit,
    FactoredMoment,
    make_optimizer,
    sgdm4bit,
)
from repro_torch.core.optimizers.transform import ChainState  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.io import CheckpointManager, format as ckfmt, writer as ckwriter  # noqa: E402
from repro_torch.io.tree import flatten_with_keys  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.launch.train import abstract_train_state  # noqa: E402
from repro_torch.train.checkpoint import migrate_legacy_state  # noqa: E402
from repro_torch.train.fault_tolerance import checkpoint_hooks, run_with_recovery  # noqa: E402
from test_torch_checkpoint import (  # noqa: E402
    _assert_moment_equal,
    _bits,
    _corrupt_midwrite,
    _j,
    _jax_state_leaves,
    _legacy_factored_to_port,
    _legacy_grads,
    _legacy_params,
    _legacy_state_to_port,
    _meta_target,
    _small_tree,
)
from test_torch_io import assert_leaves_equal, port_leaves  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("name,sr_seed", [
    ("sgdm", None), ("sgdm4bit", 3), ("sgdm4bit", None), ("adamw8bit", None),
], ids=["sgdm", "sgdm4bit_sr", "sgdm4bit_rtn_no_key", "adamw8bit"])
def test_new_optimizers_match_reference(name, sr_seed):
    """Three updates from the same params, grads and SR keys: every state
    leaf (counts, codes, scales, fp32 moments) bit-equal to the reference
    run eagerly, params within 1e-6 relative, the same state bytes."""
    from repro.core.optimizers import state_nbytes as j_state_nbytes
    from repro_torch.core.optimizers import state_nbytes

    jparams = _small_tree()
    tparams = params_from_jax(jparams, device="cpu")
    jopt, topt = j_make(name, 1e-3), make_optimizer(name, 1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    js, ts = jopt.init(jp), topt.init(tparams)
    rng = np.random.default_rng(1)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * 1e-2).astype(np.float32), jparams)
        jkey = jax.random.fold_in(jax.random.PRNGKey(sr_seed), step) if sr_seed else None
        tkey = sr.fold_in(sr.PRNGKey(sr_seed), step) if sr_seed else None
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp, key=jkey)
        tparams, ts = topt.update(params_from_jax(grads, device="cpu"), ts, tparams, key=tkey)
    jl = _jax_state_leaves(js)
    tl = [v for _, v in port_leaves(ts)]
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape, b.shape)
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"state leaf {i}")
    assert any(a.dtype == np.uint8 for a in tl) == (name != "sgdm")  # codes where quantized
    assert state_nbytes(ts) == j_state_nbytes(js)
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for k, p in tparams.items():
        np.testing.assert_allclose(p.numpy(), jflat[k].numpy(), rtol=1e-6, atol=1e-9, err_msg=k)


def test_migrate_legacy_adamw4bit_state_continues_bit_identical():
    params = _legacy_params()
    legacy = legacy_quantized_adamw(3e-3, m_policy=JQuantPolicy(config=J_M_4BIT),
                                    v_policy=JQuantPolicy(config=J_V_4BIT))
    p_l, s_l = _j(params), legacy.init(_j(params))
    for t in range(3):
        p_l, s_l = legacy.update(_j(_legacy_grads(t, params)), s_l, p_l)

    new_opt = adamw4bit(3e-3)
    migrated = migrate_legacy_state(_legacy_state_to_port(s_l), new_opt)
    assert isinstance(migrated, ChainState)
    assert isinstance(migrated.states[0].inner.m["w"], QuantizedTensor)
    assert int(migrated.states[0].count) == 3

    p_new, s_new = params_from_jax(jax.tree_util.tree_map(np.asarray, p_l), device="cpu"), migrated
    for t in range(3, 6):
        g = _legacy_grads(t, params)
        p_l, s_l = legacy.update(_j(g), s_l, p_l)
        p_new, s_new = new_opt.update(params_from_jax(g, device="cpu"), s_new, p_new)
    assert_leaves_equal(port_leaves(p_new), port_leaves(params_from_jax(
        jax.tree_util.tree_map(np.asarray, p_l), device="cpu")), "migrated params")
    _assert_moment_equal(s_new.states[0].inner.m, s_l["m"], "migrated m")
    _assert_moment_equal(s_new.states[0].inner.v, s_l["v"], "migrated v")


def test_migrate_legacy_factor4bit_state_continues():
    """A legacy factored second moment (``FactoredMoment`` leaves) migrates
    into factor4bit's chain and continues as the legacy optimizer does:
    params and the factored rows and columns within 1e-6 of the leaf's
    scale (means sum in another order), m codes bit-equal."""
    params = _legacy_params()
    legacy = legacy_quantized_adamw(3e-3, m_policy=JQuantPolicy(config=J_M_4BIT),
                                    v_policy=JQuantPolicy(config=J_V_4BIT, factor_2d=True))
    p_l, s_l = _j(params), legacy.init(_j(params))
    for t in range(3):
        p_l, s_l = legacy.update(_j(_legacy_grads(t, params)), s_l, p_l)
    new_opt = factor4bit(3e-3)
    migrated = migrate_legacy_state(_legacy_factored_to_port(s_l), new_opt)
    inner = migrated.states[0].inner
    assert isinstance(inner.v["w"], FactoredMoment) and int(migrated.states[0].count) == 3
    p_new, s_new = params_from_jax(jax.tree_util.tree_map(np.asarray, p_l), device="cpu"), migrated
    for t in range(3, 5):
        g = _legacy_grads(t, params)
        p_l, s_l = legacy.update(_j(g), s_l, p_l)
        p_new, s_new = new_opt.update(params_from_jax(g, device="cpu"), s_new, p_new)
    close = lambda a, b, what: np.testing.assert_allclose(
        a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max(), err_msg=what)
    for k, p in p_new.items():
        close(p.numpy(), np.asarray(p_l[k]), k)
    inner, want = s_new.states[0].inner, _legacy_factored_to_port(s_l)
    for k in ("w", "embed"):
        close(inner.v[k].row.numpy(), want["v"][k].row.numpy(), f"{k} row")
        close(inner.v[k].col.numpy(), want["v"][k].col.numpy(), f"{k} col")
    _assert_moment_equal(inner.m, s_l["m"], "migrated factor4bit m")


def test_migrate_legacy_state_validates_policies():
    params = _legacy_params()
    legacy = legacy_quantized_adamw(1e-3, m_policy=JQuantPolicy(config=J_M_4BIT),
                                    v_policy=JQuantPolicy(config=J_V_4BIT))
    s_l = legacy.init(_j(params))
    with pytest.raises(ValueError, match="quantization policies"):
        migrate_legacy_state(_legacy_state_to_port(s_l), adamw8bit(1e-3))


def test_migrate_legacy_sgdm_renames_m_to_trace():
    params = _legacy_params()
    legacy = legacy_sgdm4bit(5e-3)
    p_l, s_l = _j(params), legacy.init(_j(params))
    for t in range(2):
        p_l, s_l = legacy.update(_j(_legacy_grads(t, params)), s_l, p_l,
                                 key=jax.random.fold_in(jax.random.PRNGKey(9), t))
    new_opt = sgdm4bit(5e-3)
    migrated = migrate_legacy_state(_legacy_state_to_port(s_l), new_opt)
    _assert_moment_equal(migrated.states[0].inner.trace, s_l["m"], "sgdm trace")
    p_new, s_new = params_from_jax(jax.tree_util.tree_map(np.asarray, p_l), device="cpu"), migrated
    for t in range(2, 4):
        g = _legacy_grads(t, params)
        p_l, s_l = legacy.update(_j(g), s_l, p_l, key=jax.random.fold_in(jax.random.PRNGKey(9), t))
        p_new, s_new = new_opt.update(params_from_jax(g, device="cpu"), s_new, p_new,
                                      key=sr.fold_in(sr.PRNGKey(9), t))
    assert_leaves_equal(port_leaves(p_new), port_leaves(params_from_jax(
        jax.tree_util.tree_map(np.asarray, p_l), device="cpu")), "migrated sgdm params")


def test_recovery_falls_back_past_uncommitted_save(tmp_path):
    steps = 30
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, keep_last=5)
    holder = {"state": {"w": torch.zeros((4, 4)), "count": torch.tensor(0, dtype=torch.int32)}}

    def train_one(step):
        s = holder["state"]
        holder["state"] = {"w": s["w"] + 1.0, "count": s["count"] + 1}
        return float(step)

    save, restore_latest = checkpoint_hooks(
        mgr, get_state=lambda: holder["state"],
        set_state=lambda s: holder.__setitem__("state", s),
        make_target=_meta_target(holder), device="cpu")
    failed = {"done": False}

    def injector(step):
        if step == 23 and not failed["done"]:
            failed["done"] = True
            mgr.wait()
            assert mgr.latest_step() == 20
            _corrupt_midwrite(d, 20)
            assert mgr.latest_step() == 10, "completeness check missed the kill"
            return True
        return False

    losses, restarts, replayed = run_with_recovery(
        steps, train_one, save, restore_latest, checkpoint_every=10, failure_injector=injector)
    assert restarts == 1
    assert replayed == 23 - 10, "recovery did not fall back to the last COMMIT"
    assert len(losses) == steps + replayed
    assert int(holder["state"]["count"]) == steps
    assert torch.equal(holder["state"]["w"], torch.full((4, 4), float(steps)))
    mgr.wait()
    assert ckfmt.is_complete(ckfmt.step_dir(d, 20))


def test_recovery_survives_failed_async_save(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d)
    holder = {"state": {"w": torch.zeros(2)}}
    mgr.save(5, holder["state"], block=True)
    real = ckwriter.write_snapshot

    def boom(directory, step, snap, extra=None):
        raise OSError("no space left on device")

    monkeypatch.setattr(ckwriter, "write_snapshot", boom)
    mgr.save(7, holder["state"])
    mgr._writer._queue.join()  # the error is now pending
    monkeypatch.setattr(ckwriter, "write_snapshot", real)
    _, restore_latest = checkpoint_hooks(
        mgr, get_state=lambda: holder["state"],
        set_state=lambda s: holder.__setitem__("state", s),
        make_target=_meta_target(holder), device="cpu")
    with pytest.warns(UserWarning, match="discarding failed async"):
        assert restore_latest() == 5


def test_recovery_with_no_checkpoint_restarts_from_zero(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    holder = {"state": {"w": torch.zeros(2)}}

    def train_one(step):
        holder["state"] = {"w": holder["state"]["w"] + 1.0}
        return 0.0

    save, restore_latest = checkpoint_hooks(
        mgr, get_state=lambda: holder["state"],
        set_state=lambda s: holder.__setitem__("state", s),
        make_target=_meta_target(holder), device="cpu")
    fail_once = {"done": False}

    def injector(step):
        if step == 3 and not fail_once["done"]:
            fail_once["done"] = True
            holder["state"] = {"w": torch.zeros(2)}  # the node lost its state
            return True
        return False

    losses, restarts, replayed = run_with_recovery(
        8, train_one, save, restore_latest, checkpoint_every=100, failure_injector=injector)
    assert restarts == 1 and replayed == 3
    assert float(holder["state"]["w"][0]) == 8.0


def test_abstract_train_state_allocates_nothing():
    """Every param and moment of the restore target is a meta tensor; only
    the optimizer's 4-byte host step counts hold storage."""
    cfg = reduced_config("internlm2-1.8b")
    _, target = abstract_train_state(cfg, make_optimizer("production4bit", 1e-3),
                                     key=sr.PRNGKey(0))
    leaves = flatten_with_keys(target)
    assert leaves
    for key, leaf in leaves:
        if key in (".step", ".key"):
            continue
        if key.endswith(".count"):
            assert leaf.shape == () and leaf.device.type == "cpu", key
        else:
            assert leaf.is_meta, key
    model, target = abstract_train_state(cfg, make_optimizer("production4bit", 1e-3),
                                         device="cpu")
    own = {id(p) for p in model.parameters()}
    assert all(id(p) in own and not p.is_meta for p in target.params.values())

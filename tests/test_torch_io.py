"""The port's checkpoint I/O (``repro_torch.io``) against the reference's
(``repro.io``): format parity, checkpoints crossing both ways, and the
single-device cases of ``tests/test_io_sharded.py``; every other arch's
checkpoints cross in ``tests/test_torch_io_archs.py``.

Format parity is held letter for letter: from the same params, the port's
``manifest.json`` (leaf keys in order, shapes, dtypes, the ``structure``
string) equals the reference's for every port optimizer, and so do the
index files and the shard bytes. Restores are held bit for bit, with
validation on. Micro configs are the reference's ``MICRO_CFG`` (d_ff 128)
and the kernel-eligible ``KERNEL_CFG`` (d_ff 256) of
``tests/test_checkpoint_roundtrip.py``.

Cases moved out so that no port file holds more tests than
``tests/test_comms.py`` and the long files start early (pytest-xdist's
``--dist loadfile`` hands out the files with the most tests first):
the kernel config's format parity and the refused restores in
``tests/test_torch_io_fused.py``, the crossings optimizer by optimizer and
the legacy npz in ``tests/test_torch_io_cross.py``, the manifest and
shard cases in ``tests/test_torch_io_moe.py``, the spies and restore
targets in ``tests/test_torch_io_archs.py``, the async writer, retention
and GC in ``tests/test_torch_io_recurrent.py``.
"""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.io import restore_checkpoint as j_restore  # noqa: E402
from repro.io import save_checkpoint as j_save  # noqa: E402
from repro.launch.train import abstract_train_state as j_abstract  # noqa: E402
from repro.models import LayerSpec as JLayerSpec  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.train.train_loop import TrainState as JTrainState  # noqa: E402
from repro.train.train_loop import build_train_step as j_build  # noqa: E402
from repro.train.train_loop import make_train_state as j_make_state  # noqa: E402
from repro.train.train_loop import train_state_shardings as j_shardings  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import load_params, params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.io import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.io import format as ckfmt  # noqa: E402
from repro_torch.io.tree import flatten_with_keys, structure_repr  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.launch.train import abstract_train_state  # noqa: E402
from repro_torch.models import LayerSpec, ModelConfig, init_model  # noqa: E402
from repro_torch.train.train_loop import TrainState, build_train_step, make_train_state  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

_MICRO = dict(num_layers=1, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
              vocab_size=256)
OPTIMIZERS = [("adamw32", {}), ("adamw8bit", {}), ("adamw4bit", {}),
              ("adamw4bit", {"stochastic_rounding": True}), ("factor4bit", {}),
              ("adafactor", {}), ("adafactor", {"b1": 0.0}), ("sm3", {}), ("sgdm", {}),
              ("sgdm4bit", {}), ("production4bit", {}), ("shampoo32", {}), ("shampoo4bit", {})]
OPT_IDS = ["adamw32", "adamw8bit", "adamw4bit", "adamw4bit_sr", "factor4bit", "adafactor",
           "adafactor_b1_0", "sm3", "sgdm", "sgdm4bit", "production4bit", "shampoo32",
           "shampoo4bit"]
# the internlm2-1.8b checkpoint of production4bit with an SR key: fp32 params
# (1,889,110,016 of them) + state_nbytes + .step (4 B) + .key (8 B)
INTERNLM2_CKPT_BYTES = 7_556_440_064 + 4_590_578_552 + 4 + 8


def cfgs(d_ff=128):
    """(reference config, port config): MICRO_CFG (d_ff 128) or KERNEL_CFG (256)."""
    name = "micro-lm" if d_ff == 128 else "micro-kernel-lm"
    return (JModelConfig(name=name, d_ff=d_ff, blocks=(JLayerSpec("dense", 0),), remat=False,
                         **_MICRO),
            ModelConfig(name=name, d_ff=d_ff, blocks=(LayerSpec("dense", 0),), **_MICRO))


_DATA = (SyntheticLM(DataConfig(256, 16, 8, seed=2)), JSyntheticLM(JDataConfig(256, 16, 8, seed=2)))


def tbatch(t):
    return {k: torch.from_numpy(v) for k, v in _DATA[0].batch_at(t).items()}


def jbatch(t):
    return {k: jnp.asarray(v) for k, v in _DATA[1].batch_at(t).items()}


def port_model(cfg, jparams):
    """A port model on the CPU holding the reference's params."""
    model = init_model(cfg, device="cpu")
    load_params(model, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                       device="cpu"))
    return model


def host(x) -> np.ndarray:
    """A host copy (a CPU tensor's numpy view would follow in-place updates)."""
    return x.detach().cpu().numpy().copy() if isinstance(x, torch.Tensor) else np.array(x)


def port_leaves(tree):
    return [(k, host(v)) for k, v in flatten_with_keys(tree)]


def jax_leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_leaves_equal(a, b, what=""):
    """Same keys in the same order, same shapes and dtypes, same bits."""
    assert [k for k, _ in a] == [k for k, _ in b], what
    for (k, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, (what, k, x.shape, y.shape)
        np.testing.assert_array_equal(x.reshape(-1).view(np.uint8),
                                      y.reshape(-1).view(np.uint8), err_msg=f"{what} {k}")


def meta_like(tree):
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in tree.items()}


def restore_port(d, cfg, name, ov, key, step=None):
    """The port's resume: an abstract target whose params are a fresh model's
    storage on the CPU, filled in place."""
    opt = make_optimizer(name, 3e-3, **ov)
    model, target = abstract_train_state(cfg, opt, key=key, device="cpu")
    state, extra = restore_checkpoint(d, target, step=step, device="cpu")
    return model, opt, state


# ---------------------------------------------------------------------------
# (a) format parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d_ff", [128], ids=["micro"])
@pytest.mark.parametrize("name,ov", OPTIMIZERS, ids=OPT_IDS)
def test_checkpoint_bytes_match_reference(name, ov, d_ff, tmp_path):
    """The micro config's case of ``checkpoint_bytes_match_reference`` (the
    kernel-eligible one's is in ``tests/test_torch_io_fused.py``)."""
    checkpoint_bytes_match_reference(name, ov, d_ff, tmp_path)


def checkpoint_bytes_match_reference(name, ov, d_ff, tmp_path):
    """From the same params, the port writes the reference's checkpoint:
    manifest (keys, order, shapes, dtypes, structure), index and bin."""
    jcfg, cfg = cfgs(d_ff)
    jparams, _ = j_init(jax.random.PRNGKey(0), jcfg)
    jstate = j_make_state(jparams, j_make(name, 3e-3, **ov), key=jax.random.PRNGKey(5))
    tstate = make_train_state(port_model(cfg, jparams), make_optimizer(name, 3e-3, **ov),
                              key=sr.PRNGKey(5))
    dj = j_save(str(tmp_path / "jax"), 0, jstate)
    dt = save_checkpoint(str(tmp_path / "port"), 0, tstate)
    mj, mt = ckfmt.read_manifest(dj), ckfmt.read_manifest(dt)
    assert [m["key"] for m in mt["leaves"]] == [m["key"] for m in mj["leaves"]]
    assert mt["structure"] == mj["structure"]
    assert mt == mj
    assert ckfmt.read_shard_index(dt, 0) == ckfmt.read_shard_index(dj, 0)
    assert filecmp.cmp(os.path.join(dt, ckfmt.shard_file(0)),
                       os.path.join(dj, ckfmt.shard_file(0)), shallow=False)


def test_full_size_structure_matches_reference():
    """internlm2-1.8b production4bit with an SR key, as the card's smoke run
    saves it: keys, shapes, dtypes and structure of the reference's abstract
    state, and the bin's exact size."""
    jtarget, _ = j_abstract(j_get_config("internlm2-1.8b"), j_make("production4bit", 1e-3),
                            key=jax.random.PRNGKey(0))
    _, target = abstract_train_state(get_config("internlm2-1.8b"),
                                     make_optimizer("production4bit", 1e-3), key=sr.PRNGKey(0))
    assert structure_repr(target) == str(jax.tree_util.tree_structure(jtarget))
    jflat = [(jax.tree_util.keystr(p), tuple(v.shape), str(v.dtype))
             for p, v in jax.tree_util.tree_flatten_with_path(jtarget)[0]]
    tflat = [(k, tuple(v.shape), ckfmt.dtype_name(v)) for k, v in flatten_with_keys(target)]
    assert tflat == jflat
    nbytes = sum(int(np.prod(s, dtype=np.int64)) * np.dtype(d).itemsize for _, s, d in tflat)
    assert nbytes == INTERNLM2_CKPT_BYTES


# ---------------------------------------------------------------------------
# (b), (c) checkpoints cross between the frameworks
# ---------------------------------------------------------------------------


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """The reference trains 3 steps and saves; the port restores (validation
    on) bit-equal and continues 3 steps close to the reference's
    uninterrupted run: losses within 2e-4 relative (the tolerance of
    tests/test_torch_train.py; jitted JAX contracts FMAs, the port does not)
    and over 90% of the fused leaves' 4-bit first-moment codes equal."""
    jcfg, cfg = cfgs(256)
    jparams, _ = j_init(jax.random.PRNGKey(0), jcfg)
    jopt = j_make("production4bit", 3e-3)
    jstate = j_make_state(jparams, jopt, key=jax.random.PRNGKey(17))
    jstep = jax.jit(j_build(jcfg, jopt))
    for t in range(3):
        jstate, _ = jstep(jstate, jbatch(t))
    d = str(tmp_path / "c")
    j_save(d, 3, jstate)

    model, opt, state = restore_port(d, cfg, "production4bit", {}, sr.PRNGKey(17))
    assert_leaves_equal(port_leaves(state), jax_leaves(jstate), "JAX -> port @3")
    assert state.step == 3 and state.key == sr.PRNGKey(17)
    step = build_train_step(model, opt)
    for t in range(3, 6):
        jstate, jm = jstep(jstate, jbatch(t))
        state, tm = step(state, tbatch(t))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
    jm_tree = jstate.opt_state.states["4bit"][0].inner.m["decoder"][0]["sub0"]["mlp"]
    tm_tree = state.opt_state.states["4bit"].states[0].inner.m
    for w in ("w1", "w3"):
        agree = np.mean((host(tm_tree[f"decoder/0/sub0/mlp/{w}"].codes) & 0xF)
                        == (np.asarray(jm_tree[w].codes) & 0xF))
        assert agree > 0.9, (w, agree)


def _j_nonzero_state(opt_name, **ov):
    """The reference's ``_nonzero_state`` (tests/test_io_sharded.py): two
    updates on synthetic grads (jitted: only the saved leaves are compared)."""
    jcfg, cfg = cfgs()
    opt = j_make(opt_name, 3e-3, **ov)
    params, axes = j_init(jax.random.PRNGKey(0), jcfg)
    state = jax.jit(lambda p, k: j_make_state(p, opt, key=k))(params, jax.random.PRNGKey(5))
    update = jax.jit(opt.update)
    rng = np.random.default_rng(7)
    p, s = state.params, state.opt_state
    for t in range(2):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 0.02), p)
        p, s = update(grads, s, p, key=jax.random.fold_in(state.key, t))
    return JTrainState(p, s, jnp.asarray(2, jnp.int32), state.key), axes, cfg


def test_mesh_checkpoint_restores_on_one_device(tmp_path):
    """A checkpoint the reference saved on a 2x4 mesh (several shards per
    leaf in the index) restores in the port onto one device, bit-equal."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device host harness")
    jstate, axes, cfg = _j_nonzero_state("production4bit")
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    sharded = jax.device_put(jstate, j_shardings(jstate, axes, mesh, zero=True))
    d = str(tmp_path / "c")
    path = j_save(d, 2, sharded)
    shards = ckfmt.merged_shard_index(path)
    assert max(len(v) for v in shards.values()) > 1, "harness bug: nothing was split"
    _, _, state = restore_port(d, cfg, "production4bit", {}, sr.PRNGKey(5))
    assert_leaves_equal(port_leaves(state), jax_leaves(jstate), "2x4 mesh -> port")


def test_bf16_leaves_cross_both_ways(tmp_path):
    """bfloat16 leaves travel as raw 16-bit words under the name bfloat16,
    without ml_dtypes on the port's side."""
    x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    jtree = {"w": jnp.asarray(x, jnp.bfloat16)}
    ttree = {"w": torch.from_numpy(x).to(torch.bfloat16)}
    j_save(str(tmp_path / "j"), 1, jtree)
    save_checkpoint(str(tmp_path / "t"), 1, ttree)
    m = ckfmt.read_manifest(ckfmt.step_dir(str(tmp_path / "t"), 1))
    assert m["leaves"] == [{"key": "['w']", "shape": [4, 8], "dtype": "bfloat16"}]
    got, _ = restore_checkpoint(str(tmp_path / "j"), meta_like(ttree), device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), ttree["w"].view(torch.int16))
    back, _ = j_restore(str(tmp_path / "t"), jax.eval_shape(lambda: jtree))
    np.testing.assert_array_equal(np.asarray(back["w"]).view(np.uint16),
                                  np.asarray(jtree["w"]).view(np.uint16))


# ---------------------------------------------------------------------------
# (g) structure mismatch refused
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# (f) the single-device cases of tests/test_io_sharded.py
# ---------------------------------------------------------------------------


def _nonzero_state(opt_name="production4bit"):
    """A port TrainState with non-trivial quantized moments (2 updates on
    synthetic grads with SR keys)."""
    _, cfg = cfgs()
    opt = make_optimizer(opt_name, 3e-3)
    model = init_model(cfg, device="cpu")
    state = make_train_state(model, opt, key=sr.PRNGKey(5))
    rng = np.random.default_rng(7)
    p, s = state.params, state.opt_state
    for t in range(2):
        grads = {k: torch.from_numpy(rng.normal(size=x.shape).astype(np.float32) * 0.02)
                 for k, x in p.items()}
        p, s = opt.update(grads, s, p, key=sr.fold_in(state.key, t))
    return TrainState(p, s, 2, state.key), cfg


def _target_of(state, cfg, name):
    _, target = abstract_train_state(cfg, make_optimizer(name, 3e-3), key=state.key)
    return TrainState(target.params, target.opt_state, 2, target.key)


def _steps_on_disk(d):
    return sorted(ckfmt.parse_step(n) for n in os.listdir(d) if n.startswith("step_"))

"""The port's checkpoint I/O (``repro_torch.io``) against the reference's
(``repro.io``): format parity, checkpoints crossing both ways, and the
single-device cases of ``tests/test_io_sharded.py``.

Format parity is held letter for letter: from the same params, the port's
``manifest.json`` (leaf keys in order, shapes, dtypes, the ``structure``
string) equals the reference's for every port optimizer, and so do the
index files and the shard bytes. Restores are held bit for bit, with
validation on. Micro configs are the reference's ``MICRO_CFG`` (d_ff 128)
and the kernel-eligible ``KERNEL_CFG`` (d_ff 256) of
``tests/test_checkpoint_roundtrip.py``.
"""

import dataclasses
import filecmp
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_encdec import encdec_batch  # noqa: E402
from test_torch_vl import vl_batch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
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
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import load_params, params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.io import (  # noqa: E402
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.io import format as ckfmt  # noqa: E402
from repro_torch.io import reader, writer  # noqa: E402
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


@pytest.mark.parametrize("d_ff", [128, 256], ids=["micro", "kernel"])
@pytest.mark.parametrize("name,ov", OPTIMIZERS, ids=OPT_IDS)
def test_checkpoint_bytes_match_reference(name, ov, d_ff, tmp_path):
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


# hymba at reduced width with the full config's layout of scan units, five
# runs ([global], 2 windowed, [global], [windowed], [global]; the full one
# has 14 and 15 windowed layers in its runs)
HYMBA_UNITS = (0, 16, 16, 0, 16, 0)


def _io_configs(arch):
    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    if arch == "hymba-1.5b":
        L = len(HYMBA_UNITS)
        jcfg = dataclasses.replace(jcfg, num_layers=L,
                                   blocks=tuple(JLayerSpec("hymba", w) for w in HYMBA_UNITS))
        cfg = dataclasses.replace(cfg, num_layers=L,
                                  blocks=tuple(LayerSpec("hymba", w) for w in HYMBA_UNITS))
    return jcfg, cfg


def _arch_batch(cfg, data, t):
    """``data``'s batch ``t``, with a modality-stub arch's inputs in place
    of (qwen2-vl) or beside (whisper) its tokens."""
    b = data.batch_at(t)
    B, S = b["tokens"].shape
    if cfg.family == "encdec":
        b["frames"] = encdec_batch(cfg, t, B=B, Se=S)["frames"]
    if cfg.input_mode == "embeds":
        b = dict(vl_batch(cfg, t, B=B, S=S), labels=b["labels"])
    return b


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-4b", "phi3.5-moe-42b-a6.6b",
                                  "mixtral-8x7b", "xlstm-125m", "hymba-1.5b",
                                  "whisper-large-v3", "qwen2-vl-2b"])
def test_arch_checkpoints_cross_both_ways(arch, tmp_path):
    """Reduced gemma2-2b (two subs, tied embeddings: no head, 4-bit
    sandwich-norm scales), qwen3-4b (qk-norm leaves), phi3.5-moe and
    mixtral (``moe/router``, ``moe/w1``-``w3`` leaves, the expert stacks'
    4-bit moments with one rank-1 stat per dim), xlstm-125m (two units, the
    mLSTM's and the sLSTM's leaves, the 5-D ``r_gates``), hymba-1.5b
    (``HYMBA_UNITS``: five units of runs, the SSM leaves), whisper-large-v3
    (the ``encoder`` list, ``enc_norm``, LayerNorm ``{scale, bias}`` dicts,
    the decoder's ``self``/``cross`` leaves; trained on frames) and
    qwen2-vl-2b (trained on embeds with M-RoPE positions), production4bit
    with an SR
    key: from the same params the port writes the reference's files
    byte for byte; the reference trains 2 steps and saves, the port
    restores it bit-equal, trains 2 more and saves, and the reference
    restores that bit-equal."""
    jcfg, cfg = _io_configs(arch)
    jparams = jax.jit(lambda k: j_init(k, jcfg)[0])(jax.random.PRNGKey(0))
    jopt = j_make("production4bit", 3e-3)
    jstate = j_make_state(jparams, jopt, key=jax.random.PRNGKey(17))
    tstate = make_train_state(port_model(cfg, jparams), make_optimizer("production4bit", 3e-3),
                              key=sr.PRNGKey(17))
    dj = j_save(str(tmp_path / "jax0"), 0, jstate)
    dt = save_checkpoint(str(tmp_path / "port0"), 0, tstate)
    assert ckfmt.read_manifest(dt) == ckfmt.read_manifest(dj)
    assert filecmp.cmp(os.path.join(dt, ckfmt.shard_file(0)),
                       os.path.join(dj, ckfmt.shard_file(0)), shallow=False)
    keys = [m["key"] for m in ckfmt.read_manifest(dt)["leaves"]]
    assert any("'head'" in k for k in keys) == (not cfg.tie_embeddings)
    assert any("'moe'" in k and "'router'" in k for k in keys) == ("moe" in arch
                                                                   or "mixtral" in arch)
    if arch == "hymba-1.5b":
        units = {k.split("['decoder']")[1].split("]")[0] for k in keys if "['decoder']" in k}
        assert units == {f"[{u}" for u in range(5)}, units
    if arch == "whisper-large-v3":
        assert any("['encoder'][0]['sub0']['norm1']['bias']" in k for k in keys)
        assert any("['decoder'][0]['sub0']['cross']['wq']" in k for k in keys)

    data = (SyntheticLM(DataConfig(512, 16, 4)), JSyntheticLM(JDataConfig(512, 16, 4)))
    jstep = jax.jit(j_build(jcfg, jopt))
    for t in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in _arch_batch(jcfg, data[1], t).items()})
    j_save(str(tmp_path / "jax"), 2, jstate)
    model, opt, state = restore_port(str(tmp_path / "jax"), cfg, "production4bit", {},
                                     sr.PRNGKey(17))
    assert_leaves_equal(port_leaves(state), jax_leaves(jstate), f"{arch}: JAX -> port @2")
    step = build_train_step(model, opt)
    for t in range(2, 4):
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in _arch_batch(cfg, data[0], t).items()})
    save_checkpoint(str(tmp_path / "port"), 4, state)
    target = jax.eval_shape(lambda: j_make_state(jparams, jopt, key=jax.random.PRNGKey(17)))
    restored, _ = j_restore(str(tmp_path / "port"), target)
    assert_leaves_equal(jax_leaves(restored), port_leaves(state), f"{arch}: port -> JAX @4")


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


@pytest.mark.parametrize("saved,target", [
    (("adamw4bit", {}), ("adamw32", {})),
    (("adamw4bit", {}), ("adamw4bit", {"stochastic_rounding": True})),
    (("sgdm4bit", {}), ("sgdm", {})),
], ids=["adamw4bit_into_adamw32", "rtn_into_sr", "sgdm4bit_into_sgdm"])
def test_restore_rejects_structure_mismatch(saved, target, tmp_path):
    """The manifest records the state's structure, quantizer configs
    included: an RTN checkpoint does not restore into an SR target."""
    _, cfg = cfgs()
    model = init_model(cfg, device="cpu")
    state = make_train_state(model, make_optimizer(saved[0], 1e-3, **saved[1]))
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, state)
    _, wrong = abstract_train_state(cfg, make_optimizer(target[0], 1e-3, **target[1]))
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(d, wrong, device="cpu")


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


def test_manifest_v2_schema(tmp_path):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "n": torch.tensor(3, dtype=torch.int32)}
    d = str(tmp_path / "c")
    path = save_checkpoint(d, 5, tree, extra={"note": "hi"})
    assert sorted(os.listdir(path)) == ["COMMIT", "host_00000.bin", "index_host_00000.json",
                                        "manifest.json"]
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["format_version"] == 2
    assert manifest["step"] == 5 and manifest["extra"] == {"note": "hi"}
    assert manifest["num_hosts"] == 1
    assert manifest["structure"] == "PyTreeDef({'n': *, 'w': *})"
    by_key = {m["key"]: m for m in manifest["leaves"]}
    assert by_key["['w']"]["shape"] == [3, 4] and by_key["['w']"]["dtype"] == "float32"
    assert by_key["['n']"]["shape"] == [] and by_key["['n']"]["dtype"] == "int32"
    idx = json.load(open(os.path.join(path, "index_host_00000.json")))
    assert idx["process"] == 0
    recs = idx["shards"]["['w']"]
    assert sum(r["nbytes"] for r in recs) == 12 * 4
    for r in recs:
        assert len(r["index"]) == 2 and len(r["sha256"]) == 16
    assert idx["shards"]["['n']"][0]["index"] == []
    assert latest_step(d) == 5


def test_incomplete_dir_ignored_and_fallback(tmp_path):
    """A save killed mid-shard-write (truncated bin, no COMMIT) is invisible
    to latest_step; restore lands on the last complete step."""
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    d = str(tmp_path / "c")
    save_checkpoint(d, 5, tree)
    crashed = save_checkpoint(d, 9, tree)
    os.remove(os.path.join(crashed, "COMMIT"))
    bin_path = os.path.join(crashed, "host_00000.bin")
    with open(bin_path, "r+b") as f:
        f.truncate(os.path.getsize(bin_path) // 2)
    assert latest_step(d) == 5  # LATEST still says 9
    restored, _ = restore_checkpoint(d, meta_like(tree), device="cpu")
    assert torch.equal(restored["w"], tree["w"])


def test_truncated_shard_with_commit_raises(tmp_path):
    """Truncation behind a COMMIT is corruption: restore raises."""
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    d = str(tmp_path / "c")
    path = save_checkpoint(d, 1, tree)
    bin_path = os.path.join(path, "host_00000.bin")
    with open(bin_path, "r+b") as f:
        f.truncate(os.path.getsize(bin_path) - 8)
    with pytest.raises(IOError, match="truncated"):
        restore_checkpoint(d, meta_like(tree), device="cpu")


def test_corrupted_shard_raises_hash_mismatch(tmp_path):
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    d = str(tmp_path / "c")
    path = save_checkpoint(d, 1, tree)
    with open(os.path.join(path, "host_00000.bin"), "r+b") as f:
        f.seek(8)
        f.write(b"\xff")
    with pytest.raises(IOError, match="hash mismatch"):
        restore_checkpoint(d, meta_like(tree), device="cpu")
    restored, _ = restore_checkpoint(d, meta_like(tree), device="cpu", validate=False)
    assert not torch.equal(restored["w"], tree["w"])


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


def test_port_npz_readable_by_jax(tmp_path):
    state, _ = _nonzero_state("adamw4bit")
    d = str(tmp_path / "c")
    save_checkpoint(d, 4, state, fmt_version="npz")
    jcfg, _ = cfgs()
    jparams, _ = j_init(jax.random.PRNGKey(0), jcfg)
    target = jax.eval_shape(lambda: j_make_state(jparams, j_make("adamw4bit", 3e-3),
                                                 key=jax.random.PRNGKey(5)))
    restored, _ = j_restore(d, target)
    assert_leaves_equal(jax_leaves(restored), port_leaves(state), "port npz -> JAX")


def test_save_spy_copies_every_leaf_once(tmp_path, monkeypatch):
    """Every device-to-host byte goes through writer._device_to_host: one
    whole copy per leaf, nothing else."""
    state, _ = _nonzero_state()
    copies = []
    real = writer._device_to_host
    monkeypatch.setattr(writer, "_device_to_host",
                        lambda key, leaf: copies.append(key) or real(key, leaf))
    path = save_checkpoint(str(tmp_path / "c"), 1, state)
    keys = [k for k, _ in flatten_with_keys(state)]
    assert copies == keys
    total = sum(v.nbytes for _, v in port_leaves(state))
    assert os.path.getsize(os.path.join(path, ckfmt.shard_file(0))) == total


def test_restore_spy_allocates_one_region_per_leaf(tmp_path, monkeypatch):
    state, cfg = _nonzero_state()
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, state)
    regions = []
    real = reader._alloc_region
    monkeypatch.setattr(reader, "_alloc_region",
                        lambda key, shape, dtype: regions.append((key, tuple(shape)))
                        or real(key, shape, dtype))
    restored, _ = restore_checkpoint(d, _target_of(state, cfg, "production4bit"),
                                     device="cpu")
    assert regions == [(k, tuple(v.shape)) for k, v in port_leaves(state)]
    assert_leaves_equal(port_leaves(restored), port_leaves(state), "spied restore")


def test_async_save_returns_before_serialization(tmp_path, monkeypatch):
    """save() blocks only on the snapshot; COMMIT lands at wait(), and a
    second save proceeds while the first is written (double buffering)."""
    gate, started = threading.Event(), threading.Event()
    real = writer.write_snapshot

    def gated(directory, step, snap, extra=None):
        started.set()
        assert gate.wait(30), "test gate never opened"
        return real(directory, step, snap, extra)

    monkeypatch.setattr(writer, "write_snapshot", gated)
    tree = {"w": torch.arange(4096, dtype=torch.float32)}
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d)
    mgr.save(1, tree)
    assert started.wait(30), "background writer never started"
    assert not os.path.exists(os.path.join(d, "step_00000001", "COMMIT"))
    second_done = threading.Event()
    t = threading.Thread(target=lambda: (mgr.save(2, tree), second_done.set()), daemon=True)
    t.start()
    assert second_done.wait(30), "second save blocked: the writer is not double-buffered"
    gate.set()
    mgr.wait()
    t.join(30)
    assert not t.is_alive()
    assert os.path.exists(os.path.join(d, "step_00000002", "COMMIT"))
    assert latest_step(d) == 2
    assert set(mgr.commit_times) == {1, 2}


def test_async_writer_surfaces_errors(tmp_path, monkeypatch):
    def boom(directory, step, snap, extra=None):
        raise RuntimeError("disk on fire")

    monkeypatch.setattr(writer, "write_snapshot", boom)
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, {"w": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="disk on fire"):
        mgr.wait()


def test_post_commit_hook_failure_only_warns(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "c"))

    def bad_gc(step):
        raise OSError("gc failed")

    monkeypatch.setattr(mgr._writer, "_on_commit", bad_gc)
    with pytest.warns(UserWarning, match="post-commit hook failed"):
        mgr.save(1, {"w": torch.zeros(4)}, block=True)
    assert latest_step(str(tmp_path / "c")) == 1


def test_async_roundtrip_through_manager(tmp_path):
    state, cfg = _nonzero_state("adamw4bit")
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(3, state, extra={"k": 1})
    restored, extra = mgr.restore(_target_of(state, cfg, "adamw4bit"), device="cpu")
    assert extra == {"k": 1}
    assert_leaves_equal(port_leaves(restored), port_leaves(state), "manager roundtrip")


def _steps_on_disk(d):
    return sorted(ckfmt.parse_step(n) for n in os.listdir(d) if n.startswith("step_"))


def test_retention_keep_last_and_keep_every(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d, keep_last=2, keep_every=4)
    for s in range(1, 9):
        mgr.save(s, tree, block=True)
    assert _steps_on_disk(d) == [4, 7, 8]
    restored, _ = restore_checkpoint(d, meta_like(tree), step=4, device="cpu")
    assert torch.equal(restored["w"], tree["w"])


def test_gc_never_deletes_newest_complete(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d, keep_last=1)
    mgr.save(1, tree, block=True)
    assert _steps_on_disk(d) == [1]
    mgr.save(2, tree, block=True)
    assert _steps_on_disk(d) == [2]


def test_resave_keeps_durable_copy_until_commit(tmp_path, monkeypatch):
    """A re-save of a committed step stages elsewhere: a kill before its
    COMMIT leaves the original intact; the retry replaces it."""
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    d = str(tmp_path / "c")
    path = save_checkpoint(d, 1, tree)
    real = writer._barrier

    def dying_barrier(name):
        if name.startswith("ckpt_written"):
            raise RuntimeError("killed between shard write and COMMIT")
        return real(name)

    monkeypatch.setattr(writer, "_barrier", dying_barrier)
    with pytest.raises(RuntimeError, match="killed"):
        save_checkpoint(d, 1, {"w": tree["w"] * 2})
    assert ckfmt.is_complete(path) and latest_step(d) == 1
    assert any(".attempt_" in n for n in os.listdir(d))
    restored, _ = restore_checkpoint(d, meta_like(tree), device="cpu")
    assert torch.equal(restored["w"], tree["w"])

    monkeypatch.setattr(writer, "_barrier", real)
    new_tree = {"w": tree["w"] * 2}
    save_checkpoint(d, 1, new_tree)
    assert ckfmt.is_complete(path)
    assert not os.path.exists(path + ".replaced"), "backup not cleaned up"
    restored, _ = restore_checkpoint(d, meta_like(tree), device="cpu")
    assert torch.equal(restored["w"], new_tree["w"])


def test_repair_restores_set_aside_copy(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    d = str(tmp_path / "c")
    path = save_checkpoint(d, 1, tree)
    os.rename(path, path + ".replaced")  # the mid-swap kill
    assert latest_step(d) == 1
    assert ckfmt.is_complete(path) and not os.path.exists(path + ".replaced")
    restored, _ = restore_checkpoint(d, meta_like(tree), device="cpu")
    assert torch.equal(restored["w"], tree["w"])


def test_gc_drops_abandoned_timeline_after_rewind(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d, keep_last=3)
    for s in (10, 20, 30):
        mgr.save(s, tree, block=True)
    mgr.save(15, tree, block=True)  # rewound to 10, replayed to 15
    assert _steps_on_disk(d) == [10, 15]
    assert latest_step(d) == 15


def test_restore_target_with_plain_scalar_leaf(tmp_path):
    tree = {"w": torch.arange(4, dtype=torch.float32), "n": 3}
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, tree)
    target = {"w": torch.empty(4, device="meta"), "n": 3}
    restored, _ = restore_checkpoint(d, target, device="cpu")
    assert torch.equal(restored["w"], tree["w"])
    assert int(restored["n"]) == 3


def test_gc_sweeps_crash_leftovers(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d, keep_last=3)
    mgr.save(1, tree, block=True)
    crashed = save_checkpoint(d, 2, tree)
    os.remove(os.path.join(crashed, "COMMIT"))
    mgr.save(3, tree, block=True)
    assert _steps_on_disk(d) == [1, 3]


def test_restore_fills_allocated_leaves_in_place(tmp_path):
    """An allocated target leaf is filled in place (the CLI's restore into
    the model's own parameters); a meta leaf becomes a new tensor."""
    tree = {"a": torch.arange(6, dtype=torch.float32), "b": torch.ones(3, dtype=torch.int32)}
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, tree)
    own = torch.zeros(6)
    restored, _ = restore_checkpoint(
        d, {"a": own, "b": torch.empty(3, dtype=torch.int32, device="meta")}, device="cpu")
    assert restored["a"] is own and torch.equal(own, tree["a"])
    assert torch.equal(restored["b"], tree["b"])
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(d, {"a": own, "b": torch.zeros(3)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, {"a": torch.zeros(5), "b": tree["b"]}, device="cpu")


def test_restored_leaves_die_with_the_state(tmp_path):
    """Walking a tree leaves no reference cycle behind: once the caller
    drops a restored state, its leaves are freed at once, not at the next
    cyclic collection (a resumed run kept its first state a step longer)."""
    import gc
    import weakref

    tree = {"a": {"b": torch.arange(6, dtype=torch.float32)}, "c": torch.ones(3)}
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, tree)
    gc.collect()
    gc.disable()
    try:
        restored, _ = restore_checkpoint(d, {"a": {"b": torch.empty(6, device="meta")},
                                             "c": torch.empty(3, device="meta")}, device="cpu")
        refs = [weakref.ref(v) for v in (restored["a"]["b"], restored["c"])]
        del restored
        assert all(r() is None for r in refs)
    finally:
        gc.enable()

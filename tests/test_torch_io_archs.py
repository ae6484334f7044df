"""Checkpoints of every other arch cross between the port and the reference
(moved out of ``tests/test_torch_io.py``, whose helpers it uses, so that no
one file holds the suite's longest run): reduced gemma2-2b, qwen3-4b,
whisper-large-v3 and qwen2-vl-2b here, phi3.5-moe and mixtral in
``tests/test_torch_io_moe.py``, xlstm-125m and hymba-1.5b (five units of
runs) in ``tests/test_torch_io_recurrent.py``, production4bit with an SR
key, saved by each package and restored bit-equal by the other (see
``cross_both_ways``).

Also here, with ``tests/test_torch_io.py``'s helpers: the save and restore
spies, the legacy npz read by the reference, and the restore targets."""

import dataclasses
import filecmp
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM  # noqa: E402
from repro.io import restore_checkpoint as j_restore, save_checkpoint as j_save  # noqa: E402
from repro.models import init_model as j_init, LayerSpec as JLayerSpec  # noqa: E402
from repro.train.train_loop import (  # noqa: E402
    build_train_step as j_build,
    make_train_state as j_make_state,
)
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.io import (  # noqa: E402
    format as ckfmt,
    reader,
    restore_checkpoint,
    save_checkpoint,
    writer,
)
from repro_torch.io.tree import flatten_with_keys  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import LayerSpec  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402
from test_torch_encdec import encdec_batch  # noqa: E402
from test_torch_io import (  # noqa: E402
    _nonzero_state,
    _target_of,
    assert_leaves_equal,
    cfgs,
    jax_leaves,
    port_leaves,
    port_model,
    restore_port,
)
from test_torch_vl import vl_batch  # noqa: E402
from torch_ref import ref_params  # noqa: E402


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


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-4b", "whisper-large-v3", "qwen2-vl-2b"])
def test_arch_checkpoints_cross_both_ways(arch, tmp_path):
    cross_both_ways(arch, tmp_path)


def cross_both_ways(arch, tmp_path):
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
    jparams = ref_params(jcfg)
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


def test_restore_target_with_plain_scalar_leaf(tmp_path):
    tree = {"w": torch.arange(4, dtype=torch.float32), "n": 3}
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, tree)
    target = {"w": torch.empty(4, device="meta"), "n": 3}
    restored, _ = restore_checkpoint(d, target, device="cpu")
    assert torch.equal(restored["w"], tree["w"])
    assert int(restored["n"]) == 3


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

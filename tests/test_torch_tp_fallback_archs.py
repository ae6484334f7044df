"""The port's ``embed``-cut fallbacks on the mesh's model axis, end to end,
against the reference (``models.blocks.apply_attention``'s row-parallel
mode, ``models.layers.column_parallel_lookup`` and
``row_parallel_cross_entropy``).

Three cells, 2 steps of production4bit with SR from the reference's params,
8 x 32 tokens (``torch_mesh_worker``'s ``tp_step``: a world of 2 for the
(1, 2) cells, one of 4 for (2, 2), started before the reference's side
runs here, its jitted steps and ``jax.grad`` compiled in threads beside
the port's one-process gradients):

* hymba-1.5b at d_model 80, 5 heads, 5 kv heads, vocabulary 511, the
  reference's layer remat on, on (1, 2): the attention row-parallel,
  ``embed`` and ``head`` cut on their width, the SSM state-parallel;
* whisper-large-v3 at d_model 48, 3 heads, vocabulary 513, 24 frames, on
  (1, 2): the encoder's, the decoder's self- and cross-attention
  row-parallel, the tied ``embed`` cut on its width;
* gemma2-2b at d_model 48, 3 heads on 1 kv head, vocabulary 511, on (2, 2):
  GQA row-parallel with the attention and final softcaps and the window,
  the tied head cut on its width.

Held to ``tests/test_torch_recurrent_tp_archs.py``'s bars: the losses
within 2e-3 of the reference's jitted step on the same layout and
bit-equal on every rank; each leaf's gradient, gathered whole, within the
bar the port's one-process gradient meets against ``jax.grad``
(``GRAD_BAR``, or 1.1 times the one-process gap) and within ``GRAD_BAR``
of the one-process gradient; the recorded collective bytes equal to
``MeshStep.reckon``'s, call for call; every rank ran the cell's modes
(``tensor_parallel.CALLS``). Beside them, structurally on ``meta``: the
dry run's gathered bytes of the single-pod cells, and the leaves of the 10
full configs that the rules cut on ``model`` but the placement gathers
whole, which are the ones that stay whole by use.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, reduced_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import init_model, named_params, param_axes  # noqa: E402
from repro_torch.sharding import tensor_parallel as T  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402
import torch_tp_ref as R  # noqa: E402
from test_torch_tp_train import GRAD_BAR  # noqa: E402
from torch_ref import ref_params  # noqa: E402

HYMBA, WHISPER, GEMMA = "hymba-1.5b", "whisper-large-v3", "gemma2-2b"
# name: (arch, layout, config overrides)
CELLS = {
    HYMBA: (HYMBA, (1, 2), {"d_model": 80, "num_heads": 5, "num_kv_heads": 5,
                            "vocab_size": 511, "remat": True}),
    WHISPER: (WHISPER, (1, 2), {"d_model": 48, "num_heads": 3, "num_kv_heads": 3,
                                "vocab_size": 513}),
    GEMMA: (GEMMA, (2, 2), {"d_model": 48, "num_heads": 3, "num_kv_heads": 1,
                            "vocab_size": 511}),
}
FRAMES = 24
ROW = {"wq": 1, "wk": 1, "wv": 1, "wo": 3}  # a row-parallel attention's stacked leaves
# each cell's split of its attentions (by sub-tree) and of its top-level
# leaves; every cell runs all three modes
WANT = {HYMBA: ({"attn": ROW}, {"embed": 1, "head": 0}),
        WHISPER: ({"attn": ROW, "self": ROW, "cross": ROW}, {"embed": 1}),
        GEMMA: ({"attn": ROW}, {"embed": 1})}


def _configs(name):
    arch, _, over = CELLS[name]
    return (dataclasses.replace(j_reduced(arch), **over),
            dataclasses.replace(reduced_config(arch), **over))


def _batches(name):
    cfg = _configs(name)[1]
    rng = np.random.default_rng(29)
    out = []
    for t in range(2):
        b = SyntheticLM(DataConfig(cfg.vocab_size, 32, 8)).batch_at(t)
        if cfg.family == "encdec":
            b["frames"] = rng.standard_normal((8, FRAMES, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def params():
    return {n: R.flat(ref_params(_configs(n)[0])) for n in CELLS}


@pytest.fixture(scope="module")
def worlds(params, tmp_path_factory):
    tasks = {2: {}, 4: {}}
    for name, (arch, layout, over) in CELLS.items():
        tasks[layout[0] * layout[1]][name] = {
            "kind": "tp_step", "arch": arch, "meshes": [layout], "lr": R.LR,
            "sr_seed": R.SEED, "params": params[name], "batches": _batches(name),
            "overrides": over}
    return {n: worker.start(n, t, str(tmp_path_factory.mktemp(f"tp_fallback{n}")))
            for n, t in tasks.items()}


@pytest.fixture(scope="module")
def reference(params, worlds):
    """Per cell: the reference's jitted steps on its layout and its
    ``jax.grad``, compiled in threads side by side while this thread runs
    the port's one-process gradients."""

    def ref(name):
        jcfg, _ = _configs(name)
        p, batches = ref_params(jcfg), _batches(name)
        return {"losses": R.ref_losses(jcfg, jax.tree_util.tree_map(jnp.copy, p), batches,
                                       CELLS[name][1]),
                "grads": R.ref_grads(jcfg, p, batches[0])}

    with ThreadPoolExecutor(len(CELLS)) as pool:
        jobs = {name: pool.submit(ref, name) for name in CELLS}
        one = {name: R.port_grads(_configs(name)[1], params[name], _batches(name)[0])
               for name in CELLS}
        out = {name: job.result() for name, job in jobs.items()}
    for name in CELLS:
        out[name]["one_grads"] = one[name]
    return out


@pytest.fixture(scope="module")
def results(worlds, reference):
    out = {}
    for started in worlds.values():
        ranks = worker.collect(started)
        for name in ranks[0]:
            out[name] = [r[name][CELLS[name][1]] for r in ranks]
    return out


@pytest.mark.parametrize("name", list(CELLS))
def test_trains_as_the_reference(name, results, reference):
    ranks, ref = results[name], reference[name]
    got = ranks[0]["losses"]
    print(f"{name} {CELLS[name][1]}: losses {got}, the reference's {ref['losses']}")
    np.testing.assert_allclose(got, ref["losses"], atol=2e-3)
    mine = R.gaps(ref["one_grads"], ref["grads"])
    bar = {k: max(GRAD_BAR, 1.1 * v) for k, v in mine.items()}
    for rank, r in enumerate(ranks):
        assert r["losses"] == got, rank
        grads = {k: v.numpy() for k, v in r["grads"].items()}
        gap = R.gaps(grads, ref["grads"])
        assert all(gap[k] <= bar[k] for k in gap), (gap, mine)
        to_one = R.gaps(grads, ref["one_grads"])
        assert max(to_one.values()) <= GRAD_BAR, to_one
        result_bytes, calls = r["reckoned"]
        for stats, recorded in zip(r["stats_bytes"], r["recorded"]):
            assert stats == result_bytes > 0 and sorted(recorded) == sorted(calls), (name, rank)
        assert all(n > 0 for n in r["calls"].values()), (rank, r["calls"])
    print(f"{name}: gradient gap to jax.grad, largest: mesh {max(gap.values()):.3e}, one "
          f"process {max(mine.values()):.3e}; mesh to one process {max(to_one.values()):.3e}; "
          f"{len(calls)} collectives, {result_bytes:,} B a step a rank; calls {r['calls']}")


@pytest.mark.parametrize("name", list(CELLS))
def test_fallback_leaves_split(name, results):
    """Every attention of the cell row-parallel, ``embed`` and ``head`` cut
    on their width."""
    split = results[name][0]["split"]
    attn, top = WANT[name]
    seen = 0
    for k in named_params(init_model(_configs(name)[1], device="meta")):
        parts = k.split("/")
        if len(parts) == 5 and parts[3] in attn and parts[4] in attn[parts[3]]:
            assert split.get(k) == attn[parts[3]][parts[4]], (k, split.get(k))
            seen += 1
    assert seen >= 4 * len(attn), seen
    assert {k: split.get(k) for k in top} == top


# the dry run's gathered bytes a rank on the single-pod plan (fp32): the
# largest layer and the top-level leaves
GATHERED = {HYMBA: (10_416_700, 25_607_200), WHISPER: (6_584_320, 16_617_600),
            GEMMA: (19_501_056, 147_465_216), "qwen2-vl-2b": (11_710_464, 58_349_568)}


@pytest.mark.parametrize("arch", list(GATHERED))
def test_dry_run_gathers_the_fallbacks_shards(arch):
    rec = dryrun.memory_record(get_config(arch), SHAPES["train_4k"], dryrun.MESHES["single"],
                               "production4bit")
    got = (rec["memory"]["gathered_layer_bytes"], rec["memory"]["gathered_top_bytes"])
    print(f"{arch} train_4k single: gathered layer {got[0]:,} B, top-level {got[1]:,} B")
    assert rec["status"] == "ok" and got == GATHERED[arch]


def _whole_by_use(k, cut, axes):
    """A leaf the rules cut on ``model`` that the placement gathers whole
    by use: a norm, hymba's scales, an MoE router, or the ``wk``/``wv`` of
    a head-parallel attention whose kv heads the axis does not divide."""
    *parent, leaf = k.split("/")
    if leaf in ("scale", "bias"):
        leaf = parent[-1]
    if "norm" in leaf or leaf in ("scale_attn", "scale_ssm", "post1", "post2") or \
            k.endswith("/moe/router"):
        return True
    wq = "/".join(parent + ["wq"])
    return leaf in ("wk", "wv") and axes[wq][cut[wq]] == "heads"


def test_full_configs_gather_only_the_whole_by_use_leaves():
    """Over the 10 full configs on model axes of 2, 4, 8 and 16: every leaf
    the rules cut on ``model`` is placed, but the whole-by-use leaves."""
    seen = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        meta = named_params(init_model(cfg, device="meta"))
        shapes = {k: tuple(p.shape) for k, p in meta.items()}
        axes = param_axes(cfg)
        for M in (2, 4, 8, 16):
            sizes = {"data": 1, "model": M}
            cut = {k: T._model_dim(s, axes[k], sizes) for k, s in shapes.items()}
            got = T.placement(shapes, axes, sizes)
            whole = [k for k in shapes if cut[k] is not None and got[k] is None]
            bad = [k for k in whole if not _whole_by_use(k, cut, axes)]
            assert not bad, (arch, M, bad)
            assert all(got[k] in (None, cut[k]) for k in shapes), (arch, M)
            kinds = {k.rsplit("/", 1)[-1] for k in whole}
            seen[arch, M] = sorted(kinds)
    print("\n".join(f"{a} M={m}: whole by use {v}" for (a, m), v in seen.items()))
    # the kv weights of a head-parallel attention stay whole where the kv
    # heads do not divide (chatglm3's 2 on 4), and nowhere the fallback applies
    assert "wk" in seen["chatglm3-6b", 4] and "wk" not in seen[HYMBA, 2]

"""The port's recurrent blocks computing tensor-parallel on the mesh's model
axis, end to end, against the reference (``models.blocks``,
``sharding.tensor_parallel``).

Five cells, 2 steps of production4bit with SR from the reference's params,
8 x 32 tokens (``torch_mesh_worker``'s ``tp_step``: a world of 2 for the
(1, 2) cells, one of 4 for (2, 2), started before the reference's side
runs here, its jitted steps and ``jax.grad`` compiled in threads beside
the port's one-process gradients):

* reduced xlstm-125m (4 heads) on (1, 2) and (2, 2): mLSTM and sLSTM
  head-parallel, 2 heads a rank;
* xlstm-125m with 3 heads at d_model 48 on (1, 2): q/k/v and ``w_out``
  row-parallel, the cells whole on both ranks, ``r_gates`` whole;
* reduced hymba-1.5b (4 heads) on (1, 2): the SSM head-parallel beside the
  split attention;
* hymba-1.5b with 5 heads at d_model 80 on (1, 2): the full config's case,
  the SSM state-parallel (4 of 8 states a rank, ``ssm_dt`` row-parallel),
  its attention row-parallel (5 heads on 2: ``wq`` cut on ``embed``); with
  the reference's layer remat on in both packages, so each layer's forward
  collectives run twice.

Held to ``tests/test_torch_tp_archs.py``'s bars: the losses within 2e-3 of
the reference's jitted step on the same layout and bit-equal on every
rank; each leaf's gradient, gathered whole, within the bar the port's
one-process gradient meets against ``jax.grad`` (``GRAD_BAR``, or 1.1
times the one-process gap: hymba's ``ssm_D``, whose bf16 cotangent the
reference sums in bf16) and within ``GRAD_BAR`` of the one-process
gradient; the recorded collective bytes equal to ``MeshStep.reckon``'s,
call for call. And the placement of the full configs, with the dry run's
gathered layer on the single-pod plan.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro_torch.configs import SHAPES, get_config, reduced_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import init_model, named_params, param_axes, plan_scan_units  # noqa: E402
from repro_torch.sharding import tensor_parallel as T  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402
import torch_tp_ref as R  # noqa: E402
from test_torch_tp_train import GRAD_BAR  # noqa: E402
from torch_ref import ref_params  # noqa: E402

XLSTM, HYMBA = "xlstm-125m", "hymba-1.5b"
THREE = {"d_model": 48, "num_heads": 3, "num_kv_heads": 3}
FIVE = {"d_model": 80, "num_heads": 5, "num_kv_heads": 5, "remat": True}
# name: (arch, layout, config overrides)
CELLS = {"xlstm": (XLSTM, (1, 2), {}), "xlstm_2x2": (XLSTM, (2, 2), {}),
         "xlstm3": (XLSTM, (1, 2), THREE), "hymba": (HYMBA, (1, 2), {}),
         "hymba5": (HYMBA, (1, 2), FIVE)}
# the cut of each recurrent leaf of the cell's layers (dims of the stacked
# leaf), by block kind; the sLSTM's MLP splits in every cell
MLSTM_HEADS = {"w_in": 2, "wq": 2, "wk": 2, "wv": 2, "w_if": 2, "b_if": 1, "w_out": 1}
SLSTM_HEADS = {"w_gates": 3, "r_gates": 1, "w_out": 1}
WANT = {
    "xlstm": {"mlstm": MLSTM_HEADS, "slstm": SLSTM_HEADS},
    "xlstm3": {"mlstm": {"w_in": 2, "wq": 1, "wk": 1, "wv": 1, "w_if": 2, "b_if": 1,
                         "w_out": 1},
               "slstm": {"w_gates": 3, "r_gates": None, "w_out": 1}},
    "hymba": {"hymba": {"ssm_in": 2, "ssm_dt": 2, "ssm_dt_bias": 1, "ssm_B": 2, "ssm_C": 2,
                        "ssm_A_log": 1, "ssm_D": 1, "ssm_out": 1, "scale_attn": None,
                        "scale_ssm": None, "attn/wq": 2}},
    "hymba5": {"hymba": {"ssm_in": 2, "ssm_dt": 1, "ssm_dt_bias": None, "ssm_B": 3,
                         "ssm_C": 3, "ssm_A_log": None, "ssm_D": None, "ssm_out": 1,
                         "scale_attn": None, "scale_ssm": None, "attn/wq": 1}},
}
WANT["xlstm_2x2"] = WANT["xlstm"]


def _configs(name):
    arch, _, over = CELLS[name]
    return (dataclasses.replace(j_reduced(arch), **over),
            dataclasses.replace(reduced_config(arch), **over))


def _batches(name):
    data = SyntheticLM(DataConfig(_configs(name)[1].vocab_size, 32, 8))
    return [data.batch_at(t) for t in range(2)]


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
    return {n: worker.start(n, t, str(tmp_path_factory.mktemp(f"recurrent_tp{n}")))
            for n, t in tasks.items()}


@pytest.fixture(scope="module")
def reference(params, worlds):
    """Per cell: the reference's jitted steps on its layout and its
    ``jax.grad`` (one a config), compiled in threads side by side while
    this thread runs the port's one-process gradients."""
    grads_of = {n: n.replace("_2x2", "") for n in CELLS}

    def ref(name):
        jcfg, _ = _configs(name)
        p, batches = ref_params(jcfg), _batches(name)
        out = {"losses": R.ref_losses(jcfg, jax.tree_util.tree_map(jnp.copy, p), batches,
                                      CELLS[name][1])}
        if grads_of[name] == name:
            out["grads"] = R.ref_grads(jcfg, p, batches[0])
        return out

    with ThreadPoolExecutor(len(CELLS)) as pool:
        jobs = {name: pool.submit(ref, name) for name in CELLS}
        one = {name: R.port_grads(_configs(name)[1], params[name], _batches(name)[0])
               for name in set(grads_of.values())}
        out = {name: job.result() for name, job in jobs.items()}
    for name in CELLS:
        out[name]["grads"] = out[grads_of[name]]["grads"]
        out[name]["one_grads"] = one[grads_of[name]]
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
    print(f"{name}: gradient gap to jax.grad, largest: mesh {max(gap.values()):.3e}, one "
          f"process {max(mine.values()):.3e}; mesh to one process {max(to_one.values()):.3e}; "
          f"{len(calls)} collectives, {result_bytes:,} B a step a rank")


@pytest.mark.parametrize("name", list(CELLS))
def test_recurrent_leaves_split(name, results):
    """Every layer's recurrent leaves cut as the cell's mode has them (the
    stacked leaf's dim), hymba's scales whole."""
    split = results[name][0]["split"]
    cfg = _configs(name)[1]
    shapes = {k: tuple(p.shape) for k, p in named_params(init_model(cfg, device="meta")).items()}
    kinds = {f"decoder/{u}/sub{i}": s.kind for u, unit in enumerate(plan_scan_units(cfg.blocks))
             for i, s in enumerate(unit.pattern)}
    seen = 0
    for k in shapes:
        if not k.startswith("decoder/"):
            continue
        sub, rel = "/".join(k.split("/")[:3]), k.split("/", 3)[-1]
        want = WANT[name].get(kinds.get(sub, ""), {})
        if rel in want:
            assert split.get(k) == want[rel], (k, split.get(k), want[rel])
            seen += 1
    assert seen >= sum(len(w) for w in WANT[name].values()), seen


# the largest layer a rank gathers on the single-pod plan (fp32): before
# the recurrent leaves split, and now (xlstm's sLSTM layer, its r_gates
# whole: 4 heads on 16; hymba's layer with its attention row-parallel: 25
# heads on 16, 33,456,700 B while it was gathered whole)
GATHERED = {XLSTM: (14_751_744, 3_692_544), HYMBA: (67_206_700, 10_416_700)}


@pytest.mark.parametrize("arch", [XLSTM, HYMBA])
def test_dry_run_gathers_a_ranks_recurrent_leaves(arch):
    rec = dryrun.memory_record(get_config(arch), SHAPES["train_4k"], dryrun.MESHES["single"],
                               "production4bit")
    got = rec["memory"]["gathered_layer_bytes"]
    print(f"{arch} train_4k single: gathered layer {got:,} B (before {GATHERED[arch][0]:,})")
    assert rec["status"] == "ok" and got == GATHERED[arch][1]


def test_full_configs_cuts():
    """The full configs' cuts the rules give (``spec_for``), each placed:
    xlstm's on 2 and 4 ranks head-parallel, on 16 row-parallel q/k/v and
    ``w_if`` rows with ``b_if`` and ``r_gates`` whole; hymba's SSM on its
    16 states on 2, 4 and 16 ranks, ``ssm_dt`` on its rows."""
    want = {
        (XLSTM, 2): {"sub0/wq": 2, "sub0/w_if": 2, "sub0/b_if": 1, "sub0/w_in": 2,
                     "sub3/w_gates": 3, "sub3/r_gates": 1, "sub3/w_out": 1},
        (XLSTM, 4): {"sub0/wq": 2, "sub0/w_if": 2, "sub3/r_gates": 1},
        (XLSTM, 16): {"sub0/wq": 1, "sub0/w_if": 1, "sub0/b_if": None, "sub0/w_out": 1,
                      "sub3/w_gates": 3, "sub3/r_gates": None},
        (HYMBA, 2): {"sub0/ssm_in": 2, "sub0/ssm_dt": 1, "sub0/ssm_B": 3, "sub0/ssm_C": 3,
                     "sub0/ssm_D": None, "sub0/ssm_out": 1, "sub0/scale_ssm": None},
        (HYMBA, 4): {"sub0/ssm_B": 3, "sub0/ssm_dt": 1, "sub0/ssm_out": 1},
        (HYMBA, 16): {"sub0/ssm_B": 3, "sub0/ssm_dt": 1, "sub0/ssm_A_log": None},
    }
    for (arch, M), cuts in want.items():
        cfg = get_config(arch)
        meta = named_params(init_model(cfg, device="meta"))
        got = T.placement({k: tuple(p.shape) for k, p in meta.items()}, param_axes(cfg),
                          {"data": 1, "model": M})
        for rel, d in cuts.items():
            assert got[f"decoder/0/{rel}"] == d, (arch, M, rel, got[f"decoder/0/{rel}"])

"""The port's MoE layers on the (data, model) mesh, as the reference's rules
cut them (``models.moe``, ``sharding.tensor_parallel``), against the
reference and against the port's own one-process run.

* Token groups that span data shards: a shard's slots, fed the same top-k
  choices, equal ``moe_slots`` on the whole group (integers, exact), also
  where a shard's run of tokens straddles a group's edge; the layer on two
  data shards (one group of 64 split 32 / 32) gives one process's output
  bit for bit and its aux (bit-equal measured on a CPU; held to 1e-5); reduced
  phi3.5-moe and mixtral-8x7b (4 experts each) on (2, 1) with batches of
  8 x 8 (one group of 64 over the two shards), 2 steps of production4bit
  with SR from the reference's params: losses within 2e-3 of the
  reference's jitted step on that layout, losses and aux within 1e-5 of
  one process, each gradient within ``GRAD_BAR`` of one process's and
  within the bar the one-process gradient meets against ``jax.grad``
  (``tests/test_torch_tp_archs.py``'s rule: ``GRAD_BAR``, or 1.1 times the
  one-process gap where a routing choice at a near tie parts it), the
  recorded collective bytes equal to ``MeshStep.reckon``'s, call for call.
* Expert-parallel experts (``w1``/``w3``/``w2`` cut on ``experts``): the
  layer on (1, 2) and (1, 4) (2 and 1 experts a rank) gives one process's
  output, aux, input gradient and leaf gradients bit for bit, in fp32 and
  in bf16 compute; reduced phi3.5-moe on (1, 4) end to end (losses within
  2e-3 of the reference's, bit-equal on every rank, the first within 1e-5
  of one process; gradients and collectives as above).
* mlp-parallel experts (3 experts on a 2-way model axis fall through to
  ``mlp``, in both packages: ``dataclasses.replace(cfg, num_experts=3)``):
  the layer within 1e-5 of one process in fp32 compute and two bf16 ulps
  in bf16 (the partials of ``w2`` sum in another order; bit-equal
  measured in bf16 on a CPU); end to end on (1, 2) as above.
* The placement on the full configs (phi3.5-moe's 16 experts cut on
  ``experts``, mixtral's 8 on a 16-way axis on ``mlp``, the routers whole)
  and the dry run's gathered layer of each on the single-pod plan.

Two spawned worlds (``torch_mesh_worker``: ``moe_blocks`` and ``tp_step``
in 2 and 4 ranks) run while the reference's side runs here. The (2, 2)
layout, data split and experts split together, runs in the 4-rank world of
``tests/test_torch_mesh.py``.
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
from repro_torch.convert import load_params  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import Transformer, init_model, named_params, param_axes  # noqa: E402
from repro_torch.models.moe import moe_apply, moe_choose, moe_shard_groups, moe_slots  # noqa: E402
from repro_torch.sharding import tensor_parallel as T  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402
import torch_tp_ref as R  # noqa: E402
from test_torch_tp_train import GRAD_BAR  # noqa: E402
from torch_ref import ref_params  # noqa: E402

PHI, MIXTRAL = "phi3.5-moe-42b-a6.6b", "mixtral-8x7b"
# name: (arch, layout, config overrides, sequence length of the 8-row batches)
CELLS = {
    "phi_split": (PHI, (2, 1), {}, 8),  # one group of 64 over two data shards
    "mixtral_split": (MIXTRAL, (2, 1), {}, 8),
    "phi_experts": (PHI, (1, 4), {}, 16),  # one expert a rank, two whole groups
    "phi_mlp": (PHI, (1, 2), {"num_experts": 3}, 16),  # 3 experts on 2: mlp columns
}
WORLD = {"phi_split": 2, "mixtral_split": 2, "phi_experts": 4, "phi_mlp": 2}
# the layer's cases: (world, what splits, compute type)
BLOCKS = [(2, "shards", "fp32"), (2, "shards", "bf16"), (2, "experts", "fp32"),
          (2, "experts", "bf16"), (4, "experts", "fp32"), (4, "experts", "bf16"),
          (2, "mlp", "fp32"), (2, "mlp", "bf16")]
BLOCK_CUT = {"experts": {"w1": 0, "w3": 0, "w2": 0}, "mlp": {"w1": 2, "w3": 2, "w2": 1}}


def _configs(name):
    arch, _, over, _ = CELLS[name]
    return (dataclasses.replace(j_reduced(arch), **over),
            dataclasses.replace(reduced_config(arch), **over))


def _batches(name):
    arch, _, _, seq = CELLS[name]
    data = SyntheticLM(DataConfig(reduced_config(arch).vocab_size, seq, 8))
    return [data.batch_at(t) for t in range(2)]


def _layer(n_experts, seed=0):
    """One MoE layer's params (D 32, F 64), an input of 8 x 8 tokens (one
    group of 64) and a cotangent."""
    rng = np.random.default_rng(seed)
    D, Ff = 32, 64
    p = {"router": rng.normal(size=(D, n_experts)).astype(np.float32) * 0.5,
         "w1": rng.normal(size=(n_experts, D, Ff)).astype(np.float32) * 0.2,
         "w3": rng.normal(size=(n_experts, D, Ff)).astype(np.float32) * 0.2,
         "w2": rng.normal(size=(n_experts, Ff, D)).astype(np.float32) * 0.2}
    return p, rng.normal(size=(8, 8, D)).astype(np.float32), \
        rng.normal(size=(8, 8, D)).astype(np.float32)


def _block_case(split, dtype):
    p, x, cot = _layer(3 if split == "mlp" else 4)
    case = {"params": p, "x": x, "cot": cot, "dtype": dtype, "top_k": 2, "group_size": 64}
    case.update(shards=True) if split == "shards" else case.update(cut=split)
    return case


@pytest.fixture(scope="module")
def params():
    return {n: R.flat(ref_params(_configs(n)[0])) for n in CELLS}


@pytest.fixture(scope="module")
def worlds(params, tmp_path_factory):
    tasks = {2: {}, 4: {}}
    for name, (arch, layout, over, _) in CELLS.items():
        tasks[WORLD[name]][name] = {"kind": "tp_step", "arch": arch, "meshes": [layout],
                                    "lr": R.LR, "sr_seed": R.SEED, "params": params[name],
                                    "batches": _batches(name), "overrides": over}
    for n in tasks:
        tasks[n]["blocks" if n == 2 else "blocks4"] = {"kind": "moe_blocks",
                              "cases": [_block_case(s, d) for w, s, d in BLOCKS if w == n]}
    return {n: worker.start(n, t, str(tmp_path_factory.mktemp(f"moe_mesh{n}")))
            for n, t in tasks.items()}


def _one_process_steps(cfg, params, batches):
    model = Transformer(cfg, device="cpu")
    load_params(model, {k: torch.from_numpy(v) for k, v in params.items()})
    opt = make_optimizer("production4bit", R.LR)
    st = make_train_state(model, opt, key=sr.PRNGKey(R.SEED))
    fn = build_train_step(model, opt)
    rows = []
    for b in batches:
        st, m = fn(st, {k: torch.from_numpy(v) for k, v in b.items()})
        rows.append((float(m["loss"]), float(m["aux_loss"])))
    return rows


@pytest.fixture(scope="module")
def reference(params, worlds):
    """Per cell: the reference's ``jax.grad`` and jitted steps on the
    layout, compiled in threads side by side (XLA compiles outside the
    GIL) while this thread runs the port's one process."""

    def ref(name):
        jcfg, _ = _configs(name)
        p, batches = ref_params(jcfg), _batches(name)
        # a copy to the jitted step, which donates the buffers it is given
        # (the cached params serve two cells)
        return {"grads": R.ref_grads(jcfg, p, batches[0]),
                "losses": R.ref_losses(jcfg, jax.tree_util.tree_map(jnp.copy, p), batches,
                                       CELLS[name][1])}

    with ThreadPoolExecutor(len(CELLS)) as pool:
        jobs = {name: pool.submit(ref, name) for name in CELLS}
        out = {}
        for name in CELLS:
            cfg, batches = _configs(name)[1], _batches(name)
            out[name] = {"one_grads": R.port_grads(cfg, params[name], batches[0]),
                         "one_steps": _one_process_steps(cfg, params[name], batches)}
        for name, job in jobs.items():
            out[name].update(job.result())
    return out


@pytest.fixture(scope="module")
def results(worlds, reference):
    out = {}
    for started in worlds.values():
        ranks = worker.collect(started)
        for name in ranks[0]:
            out[name] = [r[name] for r in ranks]
    return out


def _one_block(case):
    """The layer in one process: (output, aux, input gradient, leaf gradients)."""
    dtype = torch.float32 if case["dtype"] == "fp32" else torch.bfloat16
    with worker._compute_dtype(dtype):
        p = {k: torch.from_numpy(v).clone().requires_grad_() for k, v in case["params"].items()}
        x = torch.from_numpy(case["x"]).to(dtype).requires_grad_()
        y, aux = moe_apply(p, x, top_k=2, group_size=64, width=case["params"]["w1"].shape[-1])
        ((y.float() * torch.from_numpy(case["cot"])).sum() + aux).backward()
    return y.detach(), aux.detach(), x.grad, {k: v.grad for k, v in p.items()}


def _block_results(results, world, split, dtype):
    i = [b for b in BLOCKS if b[0] == world].index((world, split, dtype))
    return [r[i] for r in results["blocks" if world == 2 else "blocks4"]], _block_case(split, dtype)


@pytest.mark.parametrize("case", ["random", "overflow"])
def test_split_slots_equal_the_whole_groups(case):
    """Fed one process's top-k choices, each data shard's slots (its
    tokens placed in their groups, the lower shards' counts added) are the
    whole groups' slots, for 2 and 4 shards of 3 groups of 64 (4 shards:
    a run of 48 tokens straddles a group's edge)."""
    rng = np.random.default_rng(1)
    E, D, n = 4, 32, 192
    router = torch.from_numpy(rng.normal(size=(D, E)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32))
    if case == "overflow":  # expert 2 first for every token: a third of its assignments drop
        router[:, 2] += 10.0
        x += 1.0
    T, C = 64, 40
    _, _, top_idx = moe_choose(router, x.reshape(-1, T, D).to(torch.bfloat16), 2)
    whole = moe_slots(top_idx, E, C)
    assert case == "random" or int((whole < 0).sum()) >= 64
    for shards in (2, 4):
        flat = top_idx.reshape(n, 2)
        counts = []
        for d in range(shards):
            span = moe_shard_groups(n // shards, shards, d, 2, E, group_size=T)
            assert (span.T, span.C, span.groups) == (T, C, 3)
            idx = torch.zeros((span.count * T, 2), dtype=torch.int64)
            lo = span.first * T + span.lead
            idx[span.lead:span.lead + n // shards] = flat[lo:lo + n // shards]
            pos = torch.arange(span.count * T)
            mine = ((pos >= span.lead) & (pos < span.count * T - span.trail)).reshape(-1, T)
            mask = mine[..., None, None].to(torch.float32)
            own = torch.nn.functional.one_hot(idx.reshape(-1, T, 2), E).float().mul(mask)
            counts.append((span, own.sum(dim=(1, 2))))
            before = torch.zeros(span.count, E)
            for s_prev, c_prev in counts[:-1]:
                for g in range(s_prev.count):
                    k = s_prev.first + g - span.first
                    if 0 <= k < span.count:
                        before[k] += c_prev[g]
            got = moe_slots(idx.reshape(-1, T, 2), E, C, before=before, mine=mine)
            want = whole.reshape(n, 2)[span.first * T:(span.first + span.count) * T]
            assert torch.equal(got.reshape(-1, 2)[mine.reshape(-1)],
                               want[mine.reshape(-1)]), (case, shards, d)
            assert bool((got.reshape(-1, 2)[~mine.reshape(-1)] == -1).all())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layer_on_data_shards_of_one_group(dtype, results):
    """One group of 64 split over two data shards: the output is one
    process's bit for bit, the aux (every shard's the global value) within
    1e-5, and the ranks' gradients (their mean, as the mesh step takes)
    those of one process: the input's bit for bit, each leaf's within
    ``GRAD_BAR`` (each shard's bf16 partial product rounds alone)."""
    ranks, case = _block_results(results, 2, "shards", dtype)
    y, aux, x_grad, grads = _one_block(case)
    assert torch.equal(torch.cat([r["y"] for r in ranks]), y)
    for r in ranks:
        np.testing.assert_allclose(float(r["aux"]), float(aux), rtol=1e-5)
    assert torch.equal(torch.cat([r["x_grad"] for r in ranks]) / 2, x_grad)
    mean = {k: (ranks[0]["grads"][k] + ranks[1]["grads"][k]) / 2 for k in grads}
    gap = R.gaps({k: v.numpy() for k, v in mean.items()}, {k: v.numpy() for k, v in grads.items()})
    print(f"data shards ({dtype}): aux {[float(r['aux']) for r in ranks]} one process "
          f"{float(aux)}; leaf gradient gaps {gap}")
    assert max(gap.values()) <= (1e-6 if dtype == "fp32" else GRAD_BAR), gap


def _joined(ranks, split):
    """The ranks' leaf gradients joined on the dims the split cuts."""
    cut = BLOCK_CUT[split]
    return {k: torch.cat([r["grads"][k] for r in ranks], dim=cut[k]) if k in cut
            else ranks[0]["grads"][k] for k in ranks[0]["grads"]}


@pytest.mark.parametrize("world,dtype", [(2, "fp32"), (2, "bf16"), (4, "fp32"), (4, "bf16")],
                         ids=["1x2-fp32", "1x2-bf16", "1x4-fp32", "1x4-bf16"])
def test_expert_parallel_layer_bit_equal(world, dtype, results):
    """Each rank runs its experts' buffers and the outputs are gathered:
    output, aux, the input's gradient and every leaf's gradient equal one
    process's bit for bit (the router's on every rank)."""
    ranks, case = _block_results(results, world, "experts", dtype)
    y, aux, x_grad, grads = _one_block(case)
    for r in ranks:
        assert torch.equal(r["y"], y) and torch.equal(r["aux"], aux)
        assert torch.equal(r["x_grad"], x_grad)
        assert torch.equal(r["grads"]["router"], grads["router"])
    for k, g in _joined(ranks, "experts").items():
        assert torch.equal(g, grads[k]), k


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_parallel_experts_layer(dtype, results):
    """3 experts on 2 ranks, each expert's columns split: ``w2``'s fp32
    partials summed over the pair, within 1e-5 of one process in fp32
    compute and two bf16 ulps in bf16; the leaves' gradients within
    ``GRAD_BAR`` (1e-5 in fp32)."""
    ranks, case = _block_results(results, 2, "mlp", dtype)
    y, aux, x_grad, grads = _one_block(case)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "fp32" else dict(rtol=2 ** -7, atol=2 ** -7)
    for r in ranks:
        assert torch.equal(r["y"], ranks[0]["y"])
        np.testing.assert_allclose(r["y"].float().numpy(), y.float().numpy(), **tol)
        np.testing.assert_allclose(float(r["aux"]), float(aux), rtol=1e-5)
    gap = R.gaps({k: v.float().numpy() for k, v in _joined(ranks, "mlp").items()},
                 {k: v.float().numpy() for k, v in grads.items()})
    print(f"mlp-parallel experts ({dtype}): output equal {torch.equal(ranks[0]['y'], y)}, "
          f"leaf gradient gaps {gap}")
    assert max(gap.values()) <= (1e-5 if dtype == "fp32" else GRAD_BAR), gap


def _check_trains(name, results, reference):
    """The end-to-end bars every cell shares: losses within 2e-3 of the
    reference's jitted step on the layout and bit-equal on every rank;
    gradients within the one-process bar against ``jax.grad`` and within
    ``GRAD_BAR`` of one process; collective bytes equal to the reckoning's."""
    ranks, ref = [r[CELLS[name][1]] for r in results[name]], reference[name]
    got = ranks[0]["losses"]
    print(f"{name} {CELLS[name][1]}: (loss, aux) {list(zip(got, ranks[0]['aux']))}, the "
          f"reference's losses {ref['losses']}, one process {ref['one_steps']}")
    np.testing.assert_allclose(got, ref["losses"], atol=2e-3)
    mine = R.gaps(ref["one_grads"], ref["grads"])
    bar = {k: max(GRAD_BAR, 1.1 * v) for k, v in mine.items()}
    for rank, r in enumerate(ranks):
        assert r["losses"] == got and r["aux"] == ranks[0]["aux"], rank
        grads = {k: v.numpy() for k, v in r["grads"].items()}
        gap = R.gaps(grads, ref["grads"])
        assert all(gap[k] <= bar[k] for k in gap), (gap, mine)
        to_one = R.gaps(grads, ref["one_grads"])
        assert max(to_one.values()) <= GRAD_BAR, to_one
        result_bytes, calls = r["reckoned"]
        for stats, recorded in zip(r["stats_bytes"], r["recorded"]):
            assert stats == result_bytes > 0 and sorted(recorded) == sorted(calls), (name, rank)
    print(f"{name}: gradient gap to jax.grad, largest: mesh {max(gap.values()):.3e}, one "
          f"process {max(mine.values()):.3e}; mesh to one process {max(to_one.values()):.3e}")
    return ranks[0]


@pytest.mark.parametrize("name", ["phi_split", "mixtral_split"])
def test_groups_split_over_data_shards_train(name, results, reference):
    """(2, 1), one group of 64 over the two shards: the losses and aux
    within 1e-5 of one process, every shard's logged aux the global one;
    the data group's gathers among the recorded calls."""
    r = _check_trains(name, results, reference)
    np.testing.assert_allclose(list(zip(r["losses"], r["aux"])), reference[name]["one_steps"],
                               rtol=1e-5)
    assert not r["split"]
    # one gather of each layer's counts and probability sums (1 group, 2 x 4
    # experts, fp32) over the data group
    assert r["reckoned"][1].count(("all-gather", 2 * 2 * 4 * 4, 2)) == 4


def test_expert_parallel_trains_on_four_ranks(results, reference):
    """(1, 4), one expert a rank: the experts cut on their dim, the router
    whole; the first step's loss and aux within 1e-5 of one process."""
    r = _check_trains("phi_experts", results, reference)
    moe = {k.rsplit("/", 1)[-1]: d for k, d in r["split"].items() if "/moe/" in k}
    assert moe == {"w1": 1, "w2": 1, "w3": 1}, r["split"]
    np.testing.assert_allclose((r["losses"][0], r["aux"][0]),
                               reference["phi_experts"]["one_steps"][0], rtol=1e-5)


def test_mlp_parallel_experts_train(results, reference):
    """(1, 2) with 3 experts: each expert's columns split (``w1``/``w3`` on
    their last dim, ``w2`` on its rows), the first step within 1e-5 of one
    process."""
    r = _check_trains("phi_mlp", results, reference)
    moe = {k.rsplit("/", 1)[-1]: d for k, d in r["split"].items() if "/moe/" in k}
    assert moe == {"w1": 3, "w2": 2, "w3": 3}, r["split"]
    np.testing.assert_allclose((r["losses"][0], r["aux"][0]),
                               reference["phi_mlp"]["one_steps"][0], rtol=1e-5)


def test_placement_cuts_experts_then_mlp():
    """The full configs: phi3.5-moe's 16 experts on their dim where the
    model axis divides them, else each expert's columns; mixtral's 8 on a
    16-way axis on ``mlp``; the routers whole."""
    for arch, mesh, want in ((PHI, (1, 16), 1), (PHI, (16, 16), 1), (PHI, (1, 32), 3),
                             (MIXTRAL, (1, 16), 3), (MIXTRAL, (1, 4), 1)):
        cfg = get_config(arch)
        meta = named_params(init_model(cfg, device="meta"))
        shapes = {k: tuple(p.shape) for k, p in meta.items()}
        got = T.placement(shapes, param_axes(cfg), dict(zip(("data", "model"), mesh)))
        for k, d in got.items():
            if "/moe/" in k:
                leaf = k.rsplit("/", 1)[-1]
                expect = None if leaf == "router" else (want if want == 1 or leaf != "w2"
                                                        else 2)
                assert d == expect, (arch, mesh, k, d)


# the gathered MoE layer a rank holds on the single-pod plan before the
# experts split (the whole layer, fp32)
BEFORE = {PHI: 5_075_402_752, MIXTRAL: 5_679_251_456}


@pytest.mark.parametrize("arch", [PHI, MIXTRAL])
def test_dry_run_gathers_a_ranks_experts(arch):
    """train_4k on (data=16, model=16): the rank gathers its model shard of
    the experts (phi3.5's 1 of 16 experts, mixtral's 1/16 of each expert's
    columns), so its gathered layer falls to about a sixteenth."""
    rec = dryrun.memory_record(get_config(arch), SHAPES["train_4k"], dryrun.MESHES["single"],
                               "production4bit")
    got = rec["memory"]["gathered_layer_bytes"]
    print(f"{arch} train_4k single: gathered layer {got:,} B (before the split {BEFORE[arch]:,})")
    assert rec["status"] == "ok" and BEFORE[arch] / 17 < got < BEFORE[arch] / 8

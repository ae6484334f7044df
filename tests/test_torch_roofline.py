"""The port's roofline (``repro_torch.roofline``) and its collective
reckoning against the reference and against real steps.

* The arithmetic equals the reference's: ``_ring_bytes`` of every kind at K
  in {1, 2, 4, 8, 16}; ``roofline_terms`` on three inputs, one per
  bottleneck, with the same ``HW`` on both sides; ``count_params`` and
  ``model_flops`` of all 10 full configs for the three kinds (the
  reference's params by ``jax.eval_shape`` of ``init_model``, the port's on
  ``meta``), equal as floats.
* ``comms.collectives.recording`` of calls with ``SAMPLE_HLO``'s shapes,
  dtypes and group sizes, priced by ``analysis.collective_bytes``, gives the
  dict ``collective_bytes_from_hlo`` gives, ``multiplier`` included.
* The decomposition equals the whole model: at the reduced configs of one
  arch a family, train and prefill, ``measure``'s matmul FLOPs (each type's
  and their sum) and bytes equal a whole count exactly: a real
  ``build_train_step`` step on ``meta`` (forward, backward, the update, the
  gradient norm), or the whole prefill; the total also equals
  ``FlopCounterMode``'s. xlstm-125m runs at 8 GLA chunks, so its units are
  extrapolated from probes at 2, 3 and 4 chunks, and such an extrapolation
  equals its full-length count, bytes included (a line through two probes
  misses the backward's bytes, which grow as the square of the length).
  One dense layer's FLOPs equal 2·M·N·K summed over its products, attention
  as the full square in fp32 (priced at the card's fp32 rate), the rest in
  bf16.
* The reckoning equals real steps: reduced internlm2-1.8b on (2, 1), (1, 2)
  and (2, 2) gloo worlds (``torch_mesh_worker``, started before the rest of
  this file runs and collected at its end), one step with the fp32 wire
  and one of 2 microbatches with the int4 wire: ``MeshStep.reckon`` on each
  rank's ``meta`` parts, with the real optimizer, gives ``STATS["bytes"]``
  of the real step to the byte, and the calls that ``recording`` took
  around it, one for one.
* The mesh step's packed 4-bit codes (the dry run found hymba-1.5b's odd
  last dims and phi3.5-moe's one-column router tiles failing its first
  update): reduced internlm2-1.8b with head_dim 17 (``wq/wk/wv``' codes end
  in a half byte) and d_ff 170 (``w1/w3``' tiles on (1, 2) are 85 columns
  wide, so they update on row tiles) trains 2 steps on (1, 2) within 1e-5
  of one process.

The counts (``_ring_bytes``, ``count_params``/``model_flops``, the
linear extrapolation) are in ``tests/test_torch_roofline_counts.py``, the
terms, the recorder, the dense layer and ``measure`` on a mesh in
``tests/test_torch_dryrun_all.py`` (pytest-xdist's ``--dist loadfile``
hands out the files with the most tests first).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import torch_mesh_worker as worker  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro_torch.comms import CommsConfig  # noqa: E402
from repro_torch.configs import ShapeSpec, reduced_config  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.models import init_model, named_params, param_axes  # noqa: E402
from repro_torch.models.layers import COMPUTE_DTYPE  # noqa: E402
from repro_torch.models.model import prefill  # noqa: E402
from repro_torch.roofline import analysis, measured  # noqa: E402
from repro_torch.sharding.context import MeshRun  # noqa: E402
from repro_torch.sharding.specs import local_slice, map_plan  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.train.mesh import MeshStep  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
MESH_ARCH = "internlm2-1.8b"
LAYOUTS = ((2, 1), (1, 2), (2, 2))
RUNS = (("fp32", 1), ("int4", 2))  # (wire format, microbatches)
ODD = {"head_dim": 17, "rope_variant": "none", "d_ff": 170}


def _batch():
    return SyntheticLM(DataConfig(reduced_config(MESH_ARCH).vocab_size, 32, 8)).batch_at(0)


@pytest.fixture(scope="module", autouse=True)
def worlds(tmp_path_factory):
    """(2, 1) and (1, 2) in a world of 2, (2, 2) in a world of 4, started
    first so they run while the rest of this file does."""
    task = lambda mesh: {"kind": "collectives", "arch": MESH_ARCH, "mesh": mesh,
                         "optimizer": "production4bit", "lr": 1e-3, "sr_seed": 0,
                         "batch": _batch(), "runs": RUNS}
    odd = {"kind": "losses", "arch": MESH_ARCH, "mesh": (1, 2), "optimizer": "production4bit",
           "lr": 1e-3, "sr_seed": 0, "batches": _odd_batches(), "overrides": ODD}
    by_world = {2: {(2, 1): task((2, 1)), (1, 2): task((1, 2)), "odd": odd},
                4: {(2, 2): task((2, 2))}}
    started = {n: worker.start(n, tasks, str(tmp_path_factory.mktemp(f"roofline{n}")))
               for n, tasks in by_world.items()}
    return {"started": started, "done": {}}


def _odd_batches():
    data = SyntheticLM(DataConfig(reduced_config(MESH_ARCH).vocab_size, 32, 8))
    return [data.batch_at(t) for t in range(2)]


def _world_results(worlds, n, key):
    if n not in worlds["done"]:
        worlds["done"][n] = worker.collect(worlds["started"][n])
    return [res[key] for res in worlds["done"][n]]


# ---------------------------------------------------------------------------
# (a) the arithmetic
# ---------------------------------------------------------------------------


def _ref_shapes_and_axes(arch):
    out = {}

    def capture():
        p, out["axes"] = j_init(jax.random.PRNGKey(0), j_get_config(arch))
        return p

    return jax.eval_shape(capture), out["axes"]


# ---------------------------------------------------------------------------
# (b) the recorder against the reference's HLO parse
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# (d) the decomposition against the whole model, (e) against 2·M·N·K
# ---------------------------------------------------------------------------

FAMILIES = ("internlm2-1.8b", "mixtral-8x7b", "xlstm-125m", "hymba-1.5b", "whisper-large-v3",
            "qwen2-vl-2b")
SMALL = dict(seq_len=64, global_batch=4)
# xlstm-125m at 8 chunks of its GLA, so its units are extrapolated
OVERRIDES = {"xlstm-125m": {"gla_chunk": 8}}


def _whole(cfg, shape):
    """(FlopCounterMode's total, a Counter) of a real train step on ``meta``
    (``build_train_step``: forward, backward, the update, the gradient
    norm) or of the whole prefill."""
    batch = input_specs(cfg, shape)
    model = init_model(cfg, device="meta")
    if shape.kind == "train":
        opt = make_optimizer("production4bit", 1e-4)
        step, state = build_train_step(model, opt), make_train_state(model, opt, sr.PRNGKey(0))
        run = lambda: step(state, batch)
    else:
        params = {k: torch.empty(p.shape, dtype=COMPUTE_DTYPE, device="meta")
                  for k, p in named_params(model).items()}
        run = torch.no_grad()(lambda: prefill(params, cfg, batch))
    with FlopCounterMode(display=False) as fc, measured.Counter() as c:
        run()
    return fc.get_total_flops(), c


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decomposition_equals_whole_model(arch, kind):
    cfg = dataclasses.replace(reduced_config(arch), **OVERRIDES.get(arch, {}))
    shape = ShapeSpec("small", kind=kind, **SMALL)
    rec = measured.measure(cfg, shape, optimizer="production4bit")
    total, whole = _whole(cfg, shape)
    assert rec["roofline"]["flops"] == whole.flops == total
    assert rec["flops_by_dtype"] == whole.flops_by_dtype
    assert set(whole.flops_by_dtype) == {"bfloat16", "float32"}  # fp32: the attention
    assert rec["roofline"]["bytes_accessed"] == whole.bytes
    assert rec["flops_counted"] == "matmul" and rec["compute_split"] == "data"
    names = [p["name"] for p in rec["pieces"]]
    if kind == "train":
        assert names[-1] == "tail/optimizer_update"
    # xlstm-125m's units are extrapolated from probes; the others count the
    # model with one layer a unit whole
    assert ("probe_len" in rec["pieces"][0]) == (arch == "xlstm-125m")
    assert (names[0] == "model/one_layer_a_unit") == (arch != "xlstm-125m")
    if kind == "train":  # B1's passes stand in on meta, its plain version is not counted
        b1 = rec["pieces"][-1]["b1_passes"]
        assert b1 == whole.b1 and b1["fused_adamw4"] == b1["rank1_new_stats"]


# ---------------------------------------------------------------------------
# (f) the reckoning against real gloo steps
# ---------------------------------------------------------------------------


def _reckon(layout, rank):
    """Per run: (result bytes, calls) of ``MeshStep.reckon`` on the rank's
    ``meta`` parts with the real step's optimizer and SR key."""
    cfg = reduced_config(MESH_ARCH)
    mesh = dict(zip(("data", "model"), layout))
    params = {k: p.detach() for k, p in named_params(init_model(cfg, device="meta")).items()}
    opt = make_optimizer("production4bit", 1e-3)
    with torch.no_grad():
        state = opt.init(params)
    run = MeshRun(mesh, rank=rank)
    ms = MeshStep(run, cfg, {k: tuple(p.shape) for k, p in params.items()}, param_axes(cfg),
                  params, state)
    cut = lambda t, spec: local_slice(t, spec, run.coord, mesh).clone()  # as the step holds them
    local = {k: cut(p, ms.param_plan[k]) for k, p in params.items()}
    parts = map_plan(cut, state, ms.state_plan)
    # the real step's batch, as shapes: the model group's sums follow them
    batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype, device="meta")
             for k, v in _batch().items()}
    out = []
    for mode, accum in RUNS:
        with measured.Counter():
            out.append(ms.reckon(local, parts, opt, sr.PRNGKey(0), accum, CommsConfig(mode=mode),
                                 batch=batch))
    return out


@pytest.mark.parametrize("layout", LAYOUTS, ids=["2x1", "1x2", "2x2"])
def test_reckoned_collectives_equal_real_steps(worlds, layout):
    ranks = _world_results(worlds, layout[0] * layout[1], layout)
    assert len(ranks) == layout[0] * layout[1]
    for rank, runs in enumerate(ranks):
        for (mode, accum), got, (result_bytes, calls) in zip(RUNS, runs, _reckon(layout, rank)):
            assert got["stats_bytes"] == result_bytes > 0, (layout, rank, mode)
            # the same calls, one for one (the walk takes the leaves in plan order)
            assert sorted(got["recorded"]) == sorted(calls), (layout, rank, mode)
            link = analysis.collective_bytes(calls)
            assert link["total"] > 0 and link["ops"] == len(calls) > 0


def test_packed_byte_tiles_train_as_one_process(worlds):
    cfg = dataclasses.replace(reduced_config(MESH_ARCH), **ODD)
    params = {k: p.detach() for k, p in named_params(init_model(cfg, device="meta")).items()}
    with torch.no_grad():
        state = make_optimizer("production4bit", 1e-3).init(params)
    ms = MeshStep(MeshRun({"data": 1, "model": 2}, rank=0), cfg,
                  {k: tuple(p.shape) for k, p in params.items()}, param_axes(cfg), params, state)
    assert [k for k in ms.shapes if ms.work[k] != ms.boxes[k]] == [
        "decoder/0/sub0/mlp/w1", "decoder/0/sub0/mlp/w3"]
    model = init_model(cfg, seed=0, device="cpu")
    opt = make_optimizer("production4bit", 1e-3)
    st = make_train_state(model, opt, key=sr.PRNGKey(0))
    step = build_train_step(model, opt)
    want = []
    for batch in _odd_batches():
        st, metrics = step(st, {k: torch.from_numpy(v) for k, v in batch.items()})
        want.append(float(metrics["loss"]))
    for rank_losses in _world_results(worlds, 2, "odd"):
        got = [loss for loss, _ in rank_losses]
        np.testing.assert_allclose(got, want, rtol=1e-5)

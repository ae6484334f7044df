"""The port's tensor-parallel mesh step end to end in three more configs,
against the reference (as ``tests/test_torch_tp_train.py`` holds reduced
internlm2-1.8b):

* reduced gemma2-2b on (1, 2): a tied head (``embed.T`` split on its
  vocabulary for the lookup and the cross entropy alike), the final and
  attention softcaps, sandwich norms, the (16, 0) window pattern;
* reduced chatglm3-6b on (1, 4): 2 kv heads on 4 ranks, so ``wk``/``wv``
  are gathered whole and each rank slices the kv head its q head reads;
  2-D RoPE;
* reduced phi3.5-moe on (1, 2): attention split, the experts
  expert-parallel (two of the four a rank), the router gathered (8 x 16
  tokens: two groups of 64).

Each: 2 steps of production4bit with SR from the reference's params
(``torch_mesh_worker``'s ``tp_step``; a world of 2 for gemma2 and phi3.5,
one of 4 for chatglm3), losses within 2e-3 of the reference's jitted step on
the same layout and bit-equal on every rank; each leaf's gradient, gathered
whole, within the bar the port's one-process gradient meets against
``jax.grad`` (``tests/test_torch_tp_train.py``'s ``GRAD_BAR``, or 1.1 times
the one-process gap where a routing choice at a near tie parts that one
further: phi3.5's, 8.9e-2 at most, printed beside) and within ``GRAD_BAR``
of the one-process gradient (measured on a CPU, mesh / one process
against ``jax.grad``: gemma2 1.61e-2 / 1.54e-2, chatglm3 9.34e-3 /
8.38e-3, phi3.5 8.95e-2 / 8.88e-2; mesh against one process 7.6e-3 to
1.05e-2);
the recorded collective bytes equal to ``MeshStep.reckon``'s, call for call.
phi3.5's aux loss: within ``tests/test_torch_mesh.py``'s bar (1e-5 of one
process) on the first step, and on both steps in fp32 compute; in bf16
compute the second step's routing parts at a near tie (the first update's
bf16 gradient sums part from one process's), so its aux is held to 5e-3
(2.0e-3 measured on the CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import load_params  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402
import torch_tp_ref as R  # noqa: E402
from test_torch_tp_train import GRAD_BAR  # noqa: E402
from torch_ref import ref_params  # noqa: E402

GEMMA, CHATGLM, PHI = "gemma2-2b", "chatglm3-6b", "phi3.5-moe-42b-a6.6b"
CELLS = {GEMMA: (1, 2), CHATGLM: (1, 4), PHI: (1, 2)}
# 8 x 16 tokens for the MoE arch: two whole groups of 64
SEQ = {GEMMA: 32, CHATGLM: 32, PHI: 16}


def _batches(arch):
    data = SyntheticLM(DataConfig(reduced_config(arch).vocab_size, SEQ[arch], 8))
    return [data.batch_at(t) for t in range(2)]


@pytest.fixture(scope="module")
def params():
    return {a: R.flat(ref_params(j_reduced(a))) for a in CELLS}


@pytest.fixture(scope="module")
def worlds(params, tmp_path_factory):
    task = lambda a: {"kind": "tp_step", "arch": a, "meshes": [CELLS[a]], "lr": R.LR,
                      "sr_seed": R.SEED, "params": params[a], "batches": _batches(a),
                      "fp32": a == PHI}
    by_world = {2: {a: task(a) for a in (GEMMA, PHI)}, 4: {CHATGLM: task(CHATGLM)}}
    return {n: worker.start(n, tasks, str(tmp_path_factory.mktemp(f"tp_archs{n}")))
            for n, tasks in by_world.items()}


@pytest.fixture(scope="module")
def reference(params, worlds):
    out = {}
    for a, layout in CELLS.items():
        cfg, p = j_reduced(a), ref_params(j_reduced(a))
        out[a] = {"losses": R.ref_losses(cfg, p, _batches(a), layout),
                  "grads": R.ref_grads(cfg, p, _batches(a)[0]),
                  "one_process": R.port_grads(reduced_config(a), params[a], _batches(a)[0])}
    return out


@pytest.fixture(scope="module")
def results(worlds, reference):
    out = {}
    for started in worlds.values():
        ranks = worker.collect(started)
        for a in ranks[0]:
            out[a] = [r[a][CELLS[a]] for r in ranks]
    return out


@pytest.mark.parametrize("arch", list(CELLS))
def test_losses_gradients_and_collectives(arch, results, reference):
    ranks, ref = results[arch], reference[arch]
    got = ranks[0]["losses"]
    print(f"{arch} {CELLS[arch]}: losses {got}, the reference's {ref['losses']}")
    np.testing.assert_allclose(got, ref["losses"], atol=2e-3)
    mine = R.gaps(ref["one_process"], ref["grads"])
    # the one-process bar: GRAD_BAR, or the one-process gap where a routing
    # choice at a near tie parts it further (phi3.5's experts)
    bar = {k: max(GRAD_BAR, 1.1 * v) for k, v in mine.items()}
    for rank, r in enumerate(ranks):
        assert r["losses"] == got and r["aux"] == ranks[0]["aux"]
        grads = {k: v.numpy() for k, v in r["grads"].items()}
        gap = R.gaps(grads, ref["grads"])
        assert all(gap[k] <= bar[k] for k in gap), (gap, mine)
        to_one = R.gaps(grads, ref["one_process"])
        assert max(to_one.values()) <= GRAD_BAR, to_one
        result_bytes, calls = r["reckoned"]
        for stats, recorded in zip(r["stats_bytes"], r["recorded"]):
            assert stats == result_bytes > 0 and sorted(recorded) == sorted(calls), (arch, rank)
    print(f"{arch}: gradient gap to jax.grad, largest: mesh {max(gap.values()):.3e}, one "
          f"process {max(mine.values()):.3e}; mesh to one process {max(to_one.values()):.3e}")


@pytest.mark.parametrize("arch", list(CELLS))
def test_split_and_gathered_leaves(arch, results):
    split = results[arch][0]["split"]
    names = {k.split("/", 3)[-1] if "/" in k else k for k in split}
    assert "embed" in split and ("head" in split) == (arch != GEMMA)  # gemma2's head is embed.T
    assert {"attn/wq", "attn/wo"} <= names
    assert ("attn/wk" in names) == (arch != CHATGLM)  # chatglm3: 2 kv heads on 4
    if arch == PHI:  # the experts cut on their dim, the router whole
        assert {k.rsplit("/", 1)[-1]: d for k, d in split.items() if "/moe/" in k} == {
            "w1": 1, "w2": 1, "w3": 1} and "mlp/w1" not in names
    else:
        assert {"mlp/w1", "mlp/w2", "mlp/w3"} <= names


def test_moe_aux_loss(results):
    ranks = results[PHI]
    cfg = reduced_config(PHI)
    want = {}
    for dtype in (torch.bfloat16, torch.float32):
        with worker._compute_dtype(dtype):
            model = init_model(cfg, seed=0, device="cpu")
            load_params(model, {k: torch.from_numpy(v)
                                for k, v in R.flat(ref_params(j_reduced(PHI))).items()})
            opt = make_optimizer("production4bit", R.LR)
            st = make_train_state(model, opt, key=sr.PRNGKey(R.SEED))
            fn = build_train_step(model, opt)
            rows = []
            for b in _batches(PHI):
                st, m = fn(st, {k: torch.from_numpy(v) for k, v in b.items()})
                rows.append((float(m["loss"]), float(m["aux_loss"])))
            want[dtype] = rows
    got = list(zip(ranks[0]["losses"], ranks[0]["aux"]))
    print(f"phi3.5 (1, 2): (loss, aux) {got}, one process {want[torch.bfloat16]}; fp32 compute "
          f"{ranks[0]['fp32']}, one process {want[torch.float32]}")
    np.testing.assert_allclose(got[0], want[torch.bfloat16][0], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["fp32"], want[torch.float32], rtol=1e-5)
    np.testing.assert_allclose(got[1][1], want[torch.bfloat16][1][1], rtol=5e-3)
    assert all(a > 0 for _, a in got)

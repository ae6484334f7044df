"""The port's mesh step computing tensor-parallel on the model axis, end
to end, against the reference.

Reduced internlm2-1.8b on (1, 2), (2, 2) and (1, 4) (and (2, 1), which
splits nothing), production4bit with SR, the reference's params, 2 steps
of 8 x 32 (``torch_mesh_worker``'s ``tp_step``: a world of 4 ranks for
(2, 2) and (1, 4), one of 2 for (1, 2) and (2, 1), started before the
reference's side runs here on the 8 host devices). Held to:

* the losses within 2e-3 of the reference's jitted step on the same
  layout, and bit-equal on every rank (so across every model group);
* each leaf's gradient on the first batch, gathered whole, within the bar
  that the port's one-process gradient meets against the reference's
  ``jax.grad`` (``GRAD_BAR``, relative in the 2-norm, bf16 compute:
  ``tests/test_torch_train.py``'s 3e-2; measured on a CPU: one process
  8.79e-3, the mesh 9.26e-3-9.90e-3, both printed);
* the leaves the step splits: every attention and MLP leaf and the
  vocabulary (the kv weights at (1, 4) too: 4 kv heads in the reduced
  config); none at (2, 1);
* the collective bytes each step recorded equal to ``MeshStep.reckon``'s
  on the rank's ``meta`` parts, call for call, the model group's sums
  among them (none at (2, 1)).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402
import torch_tp_ref as R  # noqa: E402
from torch_ref import ref_params  # noqa: E402

ARCH = "internlm2-1.8b"
LAYOUTS = ((1, 2), (2, 2), (1, 4))
IDS = ["1x2", "2x2", "1x4"]
# each leaf's gradient against jax.grad, relative in the 2-norm, bf16
# compute: the bar the port's one-process gradient is held to
# (tests/test_torch_train.py), which it meets here too
GRAD_BAR = 3e-2


@pytest.fixture(scope="module")
def inputs():
    cfg = j_reduced(ARCH)
    p = ref_params(cfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 8))
    return {"cfg": cfg, "p": p, "params": R.flat(p),
            "batches": [data.batch_at(t) for t in range(2)]}


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    task = lambda meshes: {"kind": "tp_step", "arch": ARCH, "meshes": meshes, "lr": R.LR,
                           "sr_seed": R.SEED, "params": inputs["params"],
                           "batches": inputs["batches"]}
    by_world = {4: task([(2, 2), (1, 4)]), 2: task([(1, 2), (2, 1)])}
    return {n: worker.start(n, {"tp": t}, str(tmp_path_factory.mktemp(f"tp{n}")))
            for n, t in by_world.items()}


@pytest.fixture(scope="module")
def reference(inputs, worlds):
    cfg, p, batches = inputs["cfg"], inputs["p"], inputs["batches"]
    return {"losses": {layout: R.ref_losses(cfg, p, batches, layout) for layout in LAYOUTS},
            "grads": R.ref_grads(cfg, p, batches[0])}


@pytest.fixture(scope="module")
def one_process(inputs, worlds):
    from repro_torch.configs import reduced_config

    return R.port_grads(reduced_config(ARCH), inputs["params"], inputs["batches"][0])


@pytest.fixture(scope="module")
def results(worlds, reference, one_process):
    out = {}
    for started in worlds.values():
        ranks = [r["tp"] for r in worker.collect(started)]
        for mesh in ranks[0]:
            out[mesh] = [r[mesh] for r in ranks]
    return out


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_losses_against_the_reference_and_across_ranks(layout, results, reference):
    ranks = results[layout]
    got = ranks[0]["losses"]
    print(f"{layout}: losses {got}, the reference's {reference['losses'][layout]}")
    np.testing.assert_allclose(got, reference["losses"][layout], atol=2e-3)
    for r in ranks[1:]:
        assert r["losses"] == got  # bit-equal on every rank, every model group
    assert len({tuple(r["model_ranks"]) for r in ranks}) == layout[0]


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_gradients_within_the_one_process_bar(layout, results, reference, one_process):
    want = reference["grads"]
    mine = R.gaps(one_process, want)
    for r in results[layout]:
        got = R.gaps({k: v.numpy() for k, v in r["grads"].items()}, want)
        print(f"{layout}: gradient gap to jax.grad, largest: mesh {max(got.values()):.3e} "
              f"({max(got, key=got.get)}), one process {max(mine.values()):.3e}")
        assert max(mine.values()) <= GRAD_BAR, mine
        assert all(v <= GRAD_BAR for v in got.values()), got


@pytest.mark.parametrize("layout", LAYOUTS + ((2, 1),), ids=IDS + ["2x1"])
def test_split_leaves_and_reckoned_collectives(layout, results):
    M = layout[1]
    for rank, r in enumerate(results[layout]):
        split = r["split"]
        if M == 1:
            assert split == {}
        else:
            assert sorted(k.rsplit("/", 1)[-1] for k in split) == sorted(
                ["embed", "head", "wq", "wk", "wv", "wo", "w1", "w2", "w3"])
        result_bytes, calls = r["reckoned"]
        for stats, recorded in zip(r["stats_bytes"], r["recorded"]):
            assert stats == result_bytes > 0, (layout, rank)
            assert sorted(recorded) == sorted(calls), (layout, rank)
        # the model group's sums (all-gathers of M pieces) where the compute is
        # split; over the world and the data group alone where it is not
        if M > 1:
            assert any(c[0] == "all-gather" and c[2] == M for c in calls)
        else:
            assert {c[2] for c in calls} == {layout[0]}

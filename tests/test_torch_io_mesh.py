"""The port's checkpoints on a mesh of processes (``repro_torch.io`` with
``shardings=``/``mesh=``, the multi-process commit protocol, the train CLI's
``--mesh`` with ``--ckpt-dir``) against the reference's sharded I/O.

One spawned world of 4 gloo ranks (``torch_mesh_worker``) and the CLI's own
2-rank worlds run while the reference's side runs here, in the pytest
process, on the 8 host devices ``tests/conftest.py`` forces. The state is a
nonzero reduced internlm2-1.8b production4bit+SR state: the reference's,
two jitted updates on seeded gradients, carried into the port by a restore
of its one-process save. Held to:

(a) the port's (2, 2) save: its manifest is a one-process save's (bar
    ``num_hosts`` = 4), the index records of the four hosts hold exactly the
    one-process bin's bytes, and the reference restores it onto its (4, 2)
    mesh and onto one device bit-equal to its own state
    (``tests/test_io_sharded.py:179``);
(b) no rank's ``_device_to_host`` copies a whole split leaf (``:208``);
(c) the reference's 2x4 save restores on (2, 2) and (1, 4): each rank's
    leaves are ``local_slice`` of the whole state under its plan, and no
    ``_alloc_region`` is whole-sized for a split leaf (``:248``);
(d) (a)'s save restored elastically on (1, 4), through
    ``checkpoint_hooks(make_shardings=)``: one mesh update fed seeded
    gradients is bit-equal to one process's update of the whole state;
(e) the protocol: rank 1 dies at the ``ckpt_written`` seam, so no COMMIT
    lands, every rank's ``wait()`` raises and ``latest_step`` falls back;
    process 0 repairs an interrupted re-save while the others wait;
(g) shampoo4bit with SR and factor4bit on (2, 1) (a world of 2 ranks of
    its own): replicated scales and factored moments (written once, by the
    lowest holder), factor stacks ZeRO-cut into ranges of whole blocks and
    SR-drawn codes; saved there after two mesh updates, restored on (1, 2)
    in the same ranks and here in one process, every leaf bit-equal to the
    saved state;
(f) the CLI (``--reduced --device cpu``): ``--mesh 2x1 --ckpt-every 2
    --steps 4`` run whole, its step-4 save then stripped of COMMIT (a run
    killed before it committed), and the same command again resumes from
    step 2 bit-equal to the whole run (losses and every rank's final state);
    ``--mesh 1x2`` and one process resume the same save within 1e-4. Every
    run keeps ``--steps 4``: the CLI's schedule spans ``--steps``, so a run
    of other length would update with other learning rates.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_mesh_worker as worker  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.io import restore_checkpoint as j_restore  # noqa: E402
from repro.io import save_checkpoint as j_save  # noqa: E402
from repro.train.train_loop import TrainState as JTrainState  # noqa: E402
from repro.train.train_loop import make_train_state as j_make_state  # noqa: E402
from repro.train.train_loop import train_state_shardings as j_shardings  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core.optimizers import FactoredMoment, make_optimizer  # noqa: E402
from repro_torch.core.optimizers.base import _leaves  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.io import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.io import format as ckfmt  # noqa: E402
from repro_torch.io.tree import flatten_with_keys, plan_of  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.train import abstract_train_state  # noqa: E402
from repro_torch.models import param_axes  # noqa: E402
from repro_torch.sharding.specs import local_box, local_slice, mesh_coords  # noqa: E402
from repro_torch.train.train_loop import train_state_shardings  # noqa: E402
from torch_ref import ref_params  # noqa: E402
from test_torch_io import assert_leaves_equal, jax_leaves, port_leaves  # noqa: E402
from test_torch_mesh import _ref_axes, _torch_leaves  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH, OPT, LR, SEED, STEP = "internlm2-1.8b", "production4bit", 3e-3, 5, 2
CLI = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
       "--optimizer", OPT, "--sr-seed", "0", "--steps", "4", "--ckpt-every", "2", "--digests"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (g): the states of rules that need whole-leaf statistics
MESH_CKPT_OPTIMIZERS = (("shampoo4bit", {"stochastic_rounding": True}), ("factor4bit", {}))


def _cli(args, run_dir):
    """The train CLI in a process of its own (it spawns its ranks)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *args,
                             "--run-dir", str(run_dir)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(proc, run_dir):
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    with open(os.path.join(run_dir, "summary.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return {k: str(tmp_path_factory.mktemp(k)) for k in (
        "one", "mesh24", "port22", "protocol", "world", "cli", "port1", "shampoo", "world2")}


@pytest.fixture(scope="module")
def grads():
    """Seeded gradients of the reduced model's shapes (numpy, whole)."""
    rng = np.random.default_rng(11)
    _, target = abstract_train_state(reduced_config(ARCH), make_optimizer(OPT, LR))
    return {k: (rng.normal(size=tuple(p.shape)) * 0.02).astype(np.float32)
            for k, p in target.params.items()}


@pytest.fixture(scope="module")
def started(paths, grads):
    """The world of 4 ranks and the CLI's first run, started before the
    reference's side; the world's tasks wait for ``ready``."""
    ready = os.path.join(paths["one"], "ready")
    base = {"arch": ARCH, "optimizer": OPT, "lr": LR, "sr_seed": SEED, "after": ready}
    tasks = {
        "save": {**base, "kind": "save", "mesh": (2, 2), "src": paths["one"],
                 "dst": paths["port22"]},
        "restore": {**base, "kind": "restore", "meshes": [(2, 2), (1, 4)],
                    "src": paths["mesh24"]},
        "resume": {**base, "kind": "resume", "mesh": (1, 4), "src": paths["port22"],
                   "grads": grads},
        "protocol": {"kind": "protocol", "dir": paths["protocol"], "timeout": 2.0,
                     "repair_delay": 0.5},
    }
    world = worker.start(4, tasks, paths["world"])
    two_steps = [grads, {k: -0.5 * v for k, v in grads.items()}]
    shampoo = worker.start(2, {name: {
        "kind": "mesh_ckpt", "arch": ARCH, "optimizer": name, "lr": LR, "overrides": ov,
        "sr_seed": SEED, "dst": os.path.join(paths["shampoo"], name), "grads": two_steps}
        for name, ov in MESH_CKPT_OPTIMIZERS}, paths["world2"])
    cli_dir = os.path.join(paths["cli"], "ckpt")
    whole = _cli(["--mesh", "2x1", "--ckpt-dir", cli_dir, *CLI],
                 os.path.join(paths["cli"], "run_whole"))
    return {"world": world, "whole": whole, "ready": ready, "cli_dir": cli_dir,
            "shampoo": shampoo}


@pytest.fixture(scope="module")
def reference(paths, started):
    """The reference's nonzero state, saved in one process and on its 2x4
    mesh (the world's inputs), and its axes."""
    cfg = j_reduced(ARCH)
    opt = j_make(OPT, LR)
    params = ref_params(cfg)
    state = jax.jit(lambda p, k: j_make_state(p, opt, key=k))(params, jax.random.PRNGKey(SEED))
    update = jax.jit(opt.update)
    rng = np.random.default_rng(7)
    p, s = state.params, state.opt_state
    for t in range(STEP):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 0.02), p)
        p, s = update(g, s, p, key=jax.random.fold_in(state.key, t))
    jstate = JTrainState(p, s, jnp.asarray(STEP, jnp.int32), state.key)
    jaxes = _ref_axes(cfg)
    j_save(paths["one"], STEP, jstate)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    j_save(paths["mesh24"], STEP, jax.device_put(jstate, j_shardings(jstate, jaxes, mesh,
                                                                      zero=True)))
    with open(started["ready"], "w") as f:
        f.write("ready")
    return {"state": jstate, "axes": jaxes}


def _port_whole(src):
    cfg = reduced_config(ARCH)
    opt = make_optimizer(OPT, LR)
    _, target = abstract_train_state(cfg, opt, key=sr.PRNGKey(SEED), device="cpu")
    state, _ = restore_checkpoint(src, target, device="cpu")
    return state, opt


@pytest.fixture(scope="module")
def one_process(paths, reference, grads):
    """The port in this process: the whole state, its one-process save, and
    its update fed ``grads``."""
    state, _ = _port_whole(paths["one"])
    leaves = port_leaves(state)
    path = save_checkpoint(paths["port1"], STEP, state)
    state, opt = _port_whole(paths["one"])
    with torch.no_grad():
        _, new = opt.update({k: torch.from_numpy(v) for k, v in grads.items()},
                            state.opt_state, state.params,
                            key=sr.fold_in(sr.PRNGKey(SEED), STEP))
    return {"leaves": leaves, "save": path, "params": state.params, "opt_state": new}


@pytest.fixture(scope="module")
def results(started, one_process):
    ranks = worker.collect(started["world"])
    return {name: [r[name] for r in ranks] for name in ranks[0]}


def _plan(sizes):
    """(whole port state's keys -> partition, coordinates) under ``sizes``."""
    return _plan_of(reduced_config(ARCH), make_optimizer(OPT, LR), sizes)


def _plan_of(cfg, opt, sizes):
    _, whole = abstract_train_state(cfg, opt, key=sr.PRNGKey(SEED))
    parts = plan_of(whole, train_state_shardings(whole, param_axes(cfg), sizes))
    return {k: parts.get(id(v)) for k, v in flatten_with_keys(whole)}, mesh_coords(sizes)


def _split(sizes, manifest):
    """Keys of the leaves whose plan cuts them, and every leaf's bytes."""
    specs, coords = _plan(sizes)
    meta = {m["key"]: m for m in manifest["leaves"]}
    split, nbytes = set(), {}
    for k, m in meta.items():
        shape = tuple(m["shape"])
        nbytes[k] = int(np.prod(shape, dtype=np.int64)) * ckfmt.dtype_from_str(
            m["dtype"]).itemsize
        whole = tuple((0, n) for n in shape)
        if specs[k] is not None and any(local_box(specs[k], shape, c, sizes) != whole
                                        for c in coords):
            split.add(k)
    return split, nbytes


S22, S14 = {"data": 2, "model": 2}, {"data": 1, "model": 4}


def test_port_mesh_save_matches_one_process_and_restores_in_reference(paths, results,
                                                                      reference, one_process):
    """(a)"""
    d = ckfmt.step_dir(paths["port22"], STEP)
    assert ckfmt.is_complete(d)
    m, one = ckfmt.read_manifest(d), ckfmt.read_manifest(one_process["save"])
    assert m["num_hosts"] == 4 and one["num_hosts"] == 1
    assert {**m, "num_hosts": 1} == one
    recs = [r for rs in ckfmt.merged_shard_index(d).values() for r in rs]
    one_bin = os.path.getsize(os.path.join(one_process["save"], ckfmt.shard_file(0)))
    assert sum(r["nbytes"] for r in recs) == one_bin
    assert sum(os.path.getsize(os.path.join(d, ckfmt.shard_file(p))) for p in range(4)) == one_bin
    assert {r["file"] for r in recs} == {ckfmt.shard_file(p) for p in range(4)}
    jstate, jaxes = reference["state"], reference["axes"]
    target = jax.eval_shape(lambda: jstate)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    for sh in (j_shardings(target, jaxes, mesh, zero=True), None):
        got, _ = j_restore(paths["port22"], target, shardings=sh)
        assert_leaves_equal(jax_leaves(got), jax_leaves(jstate), f"port (2, 2) -> JAX {sh}")


def test_mesh_save_never_copies_a_whole_split_leaf(paths, results):
    """(b) every device-to-host copy of a leaf the (2, 2) plan cuts is
    smaller than the leaf; every byte written was copied once."""
    m = ckfmt.read_manifest(ckfmt.step_dir(paths["port22"], STEP))
    split, nbytes = _split(S22, m)
    assert split, "harness: the plan cuts nothing"
    copies = [c for r in results["save"] for c in r["copies"]]
    for key, n in copies:
        if key in split:
            assert n < nbytes[key], key
    bins = sum(os.path.getsize(os.path.join(ckfmt.step_dir(paths["port22"], STEP),
                                            ckfmt.shard_file(p))) for p in range(4))
    assert sum(n for _, n in copies) == bins


@pytest.mark.parametrize("sizes", [S22, S14], ids=["2x2", "1x4"])
def test_reference_mesh_save_restores_on_port_mesh(sizes, paths, results, one_process):
    """(c) the reference's 2x4 save on (2, 2) / (1, 4): each rank's leaves
    are its plan's slice of the whole state, and no region is whole-sized
    for a split leaf."""
    shape = (sizes["data"], sizes["model"])
    whole = dict(one_process["leaves"])
    specs, coords = _plan(sizes)
    split, nbytes = _split(sizes, ckfmt.read_manifest(ckfmt.step_dir(paths["mesh24"], STEP)))
    assert split
    for r, res in enumerate(results["restore"]):
        got = res[shape]
        assert [k for k, _ in got["leaves"]] == list(whole)
        for k, leaf in got["leaves"]:
            want = whole[k]
            if specs[k] is not None:
                want = local_slice(torch.from_numpy(want), specs[k], coords[r], sizes).numpy()
            a = leaf.numpy()
            assert a.shape == want.shape and a.dtype == want.dtype, (r, k)
            np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                          np.ascontiguousarray(want).reshape(-1).view(np.uint8),
                                          err_msg=f"rank {r} {k}")
        for k, n in got["regions"]:
            if k in split:
                assert n < nbytes[k], (r, k)


def test_elastic_resume_update_bit_equal_one_process(results, one_process):
    """(d) (a)'s (2, 2) save on (1, 4), one update: every rank's gathered
    params and state bit-equal to one process's."""
    for r in results["resume"]:
        assert r["resumed"] == r["step"] == STEP
        got, mine = _torch_leaves(r["opt_state"]), _torch_leaves(one_process["opt_state"])
        assert len(got) == len(mine)
        for i, (a, b) in enumerate(zip(got, mine)):
            assert torch.equal(a, b), i
        for k, p in r["params"].items():
            assert torch.equal(p, one_process["params"][k]), k


def test_rank_dying_before_its_index_leaves_no_commit(results):
    """(e) rank 1 dies at the ``ckpt_written`` seam: no COMMIT, every rank's
    ``wait()`` raises (rank 1 its own error, the others their rendezvous
    timeouts), and every rank falls back to step 1, whose parts it reads."""
    res = results["protocol"]
    assert all(r["committed_1"] for r in res)
    assert "killed" in res[1]["error"]
    for r in (0, 2, 3):
        assert res[r]["error"].startswith("TimeoutError"), res[r]["error"]
    for rank, r in enumerate(res):
        assert r["latest"] == 1 and not r["commit_2"]
        assert r["restored"].tolist() == [100.0 + rank]


def test_repair_by_process_0_while_others_wait(results):
    """(e) a re-save of step 1 killed between its renames: process 0 puts the
    set-aside copy back half a second late; the others wait for it and find
    step 1, as process 0 does."""
    res = results["protocol"]
    assert all(r["repaired_latest"] == 1 for r in res)
    for r in res[1:]:
        assert r["return_t"] >= res[0]["scan_t"]


@pytest.fixture(scope="module")
def mesh_ckpts(started, results):
    ranks = worker.collect(started["shampoo"])
    return {name: [r[name] for r in ranks] for name, _ in MESH_CKPT_OPTIMIZERS}


def _state_tensors(state):
    """Every tensor of a state, in order (a factored moment's row and col)."""
    out = []
    for leaf in _leaves(state):
        out += ([leaf.codes, *leaf.scales] if isinstance(leaf, QuantizedTensor)
                else [leaf.row, leaf.col] if isinstance(leaf, FactoredMoment) else [leaf])
    return out


@pytest.mark.parametrize("name,ov", MESH_CKPT_OPTIMIZERS, ids=["shampoo4bit_sr", "factor4bit"])
def test_whole_leaf_rules_mesh_save_restores_on_another_layout_and_one_process(
        name, ov, paths, mesh_ckpts):
    """(g)"""
    ranks = mesh_ckpts[name]
    saved = ranks[0]["saved"]
    want = _state_tensors(saved["opt_state"])
    assert want
    for r in ranks:  # every rank gathers the same whole states
        for what in ("saved", "restored"):
            got = _state_tensors(r[what]["opt_state"])
            assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
            for k, p in r[what]["params"].items():
                assert torch.equal(p, saved["params"][k]), (what, k)
    assert ranks[0]["restored"]["step"] == 2
    cfg, opt = reduced_config(ARCH), make_optimizer(name, LR, **ov)
    specs, _ = _plan_of(cfg, opt, {"data": 2, "model": 1})
    if name == "shampoo4bit":  # the stacks are cut over data: a whole stack is no rank's part
        assert any("stats_l" in k and specs[k] is not None and any(specs[k]) for k in specs)
    else:  # the factored moments are replicated: written once, by rank 0
        assert any(".row" in k and specs[k] is not None and not any(specs[k]) for k in specs)
    _, target = abstract_train_state(cfg, opt, key=sr.PRNGKey(SEED), device="cpu")
    one, _ = restore_checkpoint(os.path.join(paths["shampoo"], name), target, device="cpu")
    got = _state_tensors(one.opt_state)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    for k, p in one.params.items():
        assert torch.equal(p.detach(), saved["params"][k]), k


@pytest.fixture(scope="module")
def cli(paths, started, results):
    """(f) the whole 2x1 run, then its save stripped of the step-4 COMMIT and
    resumed: on 2x1 and 1x2 (each in a copy) and in one process."""
    whole = _finish(started["whole"], os.path.join(paths["cli"], "run_whole"))
    d = started["cli_dir"]
    assert ckfmt.list_steps(d) == [2, 4]
    os.remove(os.path.join(ckfmt.step_dir(d, 4), ckfmt.COMMIT))
    dirs = {}
    for name in ("1x2", "one"):
        dirs[name] = os.path.join(paths["cli"], f"ckpt_{name}")
        shutil.copytree(d, dirs[name])
    procs = {m: _cli(["--mesh", m, "--ckpt-dir", dirs.get(m, d), *CLI],
                     os.path.join(paths["cli"], f"run_{m}")) for m in ("2x1", "1x2")}
    one = train.main(CLI + ["--ckpt-dir", dirs["one"]])
    out = {m: _finish(p, os.path.join(paths["cli"], f"run_{m}")) for m, p in procs.items()}
    return {"whole": whole, "one": one, **out}


def test_cli_mesh_resume_bit_equal_uninterrupted(cli):
    whole, again = cli["whole"], cli["2x1"]
    assert [r["checkpoint"]["resumed_from"] for r in whole["ranks"]] == [0, 0]
    assert [s["step"] for s in whole["checkpoint"]["saves"]] == [2, 4]
    assert [r["checkpoint"]["resumed_from"] for r in again["ranks"]] == [2, 2]
    assert all(r["checkpoint"]["restore_s"] >= 0 for r in again["ranks"])
    assert [s["step"] for s in again["steps"]] == [2, 3]
    assert [s["loss"] for s in again["steps"]] == [s["loss"] for s in whole["steps"][2:]]
    for a, b in zip(whole["ranks"], again["ranks"]):
        assert a["digests"] == b["digests"], a["rank"]
        assert a["state_bytes"] == b["state_bytes"]
    for rec in again["checkpoint"]["saves"]:
        assert rec["step"] == 4 and rec["commit_s"] >= 0 and rec["stall_ms"] >= 0


@pytest.mark.parametrize("run", ["1x2", "one"])
def test_cli_resumes_on_other_layouts(run, cli):
    whole, res = cli["whole"], cli[run]
    assert res["checkpoint"]["resumed_from"] == 2
    assert [s["step"] for s in res["steps"]] == [2, 3]
    np.testing.assert_allclose([s["loss"] for s in res["steps"]],
                               [s["loss"] for s in whole["steps"][2:]], rtol=1e-4)

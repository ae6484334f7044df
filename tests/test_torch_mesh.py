"""The port's mesh train step on (data, model) meshes of gloo processes
against the reference.

Two spawned worlds (``torch_mesh_worker``: (2, 2) and (1, 4) in 4 ranks,
(2, 1) in 2; a ``FileStore`` in ``tmp_path``, one thread per rank; (1, 4)
cuts the fused ``mlp/w1``/``w3`` tiles inside B128 blocks, so the step
updates those leaves on row tiles) run while the
reference's side runs here, in the pytest process, on the 8 host devices
``tests/conftest.py`` forces. Reduced internlm2-1.8b, production4bit with
SR, the reference's params and its gradients of two batches. Held to:

* fed those gradients for 2 steps, codes and scales bit-equal to the eager
  reference's ``opt.update`` and params within 1e-6 (the bar of
  ``tests/test_torch_optim.py``: torch's CPU ``sqrt``), and every leaf
  bit-equal to the port's one-process update;
* run end to end for 2 steps, losses within 2e-3 of the reference's jitted
  (2, 4) step and within 1e-5 of the port's one-process run (3e-5 where
  the compute is split over a model axis, whose sums of bf16 gradients
  reach the 4-bit update; in fp32 compute those runs hold 1e-5);
* each rank holds only its plan's tiles (shapes) and its plan's state bytes;
* a MoE arch (reduced phi3.5-moe) forms its token groups over the global
  batch: on (2, 1) with whole groups in each data shard, and on (2, 2) with
  one group of 64 split over the two data shards and the experts split
  over the two model ranks (the routing's counts gathered over the data
  group, the experts' outputs over the model group), losses and aux within
  1e-5 of one process: on (2, 2) the first step's and, in fp32 compute,
  both steps'; in bf16 compute the model group's sums of bf16 gradients
  reach the 4-bit update, so the second step's are held to 1e-4 (4.1e-5
  measured on a CPU) (``tests/test_torch_moe_mesh.py`` holds the other
  layouts against the reference).

Also here: the logical-axes tree of all 10 archs against the
reference's (``tests/test_torch_sharding.py``'s ``_ref_axes``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.core.quantizer import QuantizedTensor as JQ  # noqa: E402
from repro.models import init_model as j_init, loss_fn as j_loss  # noqa: E402
from repro.sharding import batch_shardings as j_batch_shardings  # noqa: E402
from repro.train.train_loop import (  # noqa: E402
    build_train_step as j_build,
    jit_train_step as j_jit,
    make_train_state as j_make_state,
    train_state_shardings as j_state_shardings,
)
from repro_torch.configs import ARCHS, reduced_config  # noqa: E402
from repro_torch.convert import load_params, params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.core.optimizers.base import _leaves  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import init_model, param_axes, Transformer  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402
from test_torch_sharding import _ref_axes as _ref_axes_of_arch  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402
from torch_ref import ref_params  # noqa: E402

ARCH, LR, SEED = "internlm2-1.8b", 1e-3, 0


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.fixture(scope="module")
def inputs():
    """The reference's params (jitted init) and gradients of two batches at
    them: what every run below is fed."""
    cfg = j_reduced(ARCH)
    p = ref_params(cfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 8))
    batches = [data.batch_at(t) for t in range(2)]
    grad_fn = jax.jit(jax.grad(lambda p, b: j_loss(p, cfg, b)[0]))
    grads = [grad_fn(p, {k: jnp.asarray(v) for k, v in b.items()}) for b in batches]
    flat = lambda tree: {k: v.numpy() for k, v in params_from_jax(jax.device_get(tree),
                                                                  "cpu").items()}
    return {"cfg": cfg, "p": p, "batches": batches, "grads": grads,
            "params0": flat(p), "grads_np": [flat(g) for g in grads]}


def _step_task(inputs, mesh):
    return {"kind": "step", "arch": ARCH, "mesh": mesh, "optimizer": "production4bit",
            "lr": LR, "sr_seed": SEED, "params": inputs["params0"], "grads": inputs["grads_np"],
            "batches": inputs["batches"]}


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """A world of 4 ranks ((2, 2), then (1, 4), whose tiles cut the fused
    ``mlp/w1``/``w3`` leaves' B128 blocks) and one of 2 ((2, 1)), started;
    they run while the reference and the one-process port compute."""
    by_world = {4: {**{m: _step_task(inputs, m) for m in ((2, 2), (1, 4))},
                    "moe_split": dict(_moe_task((2, 2), 8), fp32=True)},
                2: {(2, 1): _step_task(inputs, (2, 1)), "moe": _moe_task((2, 1), 16)}}
    return {n: worker.start(n, tasks, str(tmp_path_factory.mktemp(f"world{n}")))
            for n, tasks in by_world.items()}


MOE = "phi3.5-moe-42b-a6.6b"


def _moe_batches(seq):
    """Two batches of 8 x ``seq``: at 16, 128 tokens, two groups of 64 at the
    reduced config, so each of two data shards holds one whole group; at 8,
    one group of 64 that the two shards split."""
    data = SyntheticLM(DataConfig(reduced_config(MOE).vocab_size, seq, 8))
    return [data.batch_at(t) for t in range(2)]


def _moe_task(mesh, seq):
    return {"kind": "losses", "arch": MOE, "mesh": mesh, "optimizer": "production4bit",
            "lr": LR, "sr_seed": SEED, "batches": _moe_batches(seq)}


@pytest.fixture(scope="module")
def reference(inputs, worlds):
    """The eager update fed the two gradients, and the jitted (2, 4) step's
    losses over the two batches."""
    cfg, p = inputs["cfg"], inputs["p"]
    opt = j_make("production4bit", LR)
    s = opt.init(p)
    for t, g in enumerate(inputs["grads"]):
        p, s = opt.update(g, s, p, key=jax.random.fold_in(jax.random.PRNGKey(SEED), t))  # eager
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    jaxes = _ref_axes(cfg)
    state = j_make_state(inputs["p"], opt, key=jax.random.PRNGKey(SEED))
    # placed as the step's outputs are, so the second step reuses the first's program
    state = jax.device_put(state, j_state_shardings(state, jaxes, mesh))
    batches = [jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                              j_batch_shardings(b, mesh)) for b in inputs["batches"]]
    step = j_jit(j_build(cfg, opt, mesh, jaxes, zero=True), state, batches[0], jaxes, mesh)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": params_from_jax(jax.device_get(p), "cpu"), "state": s}


def _ref_axes(cfg):
    out = {}

    def init():
        params, out["axes"] = j_init(jax.random.PRNGKey(0), cfg)
        return params

    jax.eval_shape(init)
    return out["axes"]


@pytest.fixture(scope="module")
def one_process(inputs, worlds):
    """The port in one process: its update fed the same gradients, and its
    end-to-end losses."""
    cfg = reduced_config(ARCH)
    key = sr.PRNGKey(SEED)

    def fresh():
        model = Transformer(cfg, device="cpu")
        load_params(model, {k: torch.from_numpy(v) for k, v in inputs["params0"].items()})
        opt = make_optimizer("production4bit", LR)
        return model, opt, make_train_state(model, opt, key=key)

    model, opt, state = fresh()
    for t, g in enumerate(inputs["grads_np"]):
        with torch.no_grad():
            _, state.opt_state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                            state.opt_state, state.params,
                                            key=sr.fold_in(key, t))
    params = {k: p.detach().clone() for k, p in state.params.items()}
    model, opt, st = fresh()
    fn = build_train_step(model, opt)
    losses = []
    for b in inputs["batches"]:
        st, m = fn(st, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    with worker._compute_dtype(torch.float32):
        model, opt, st = fresh()
        losses_fp32 = worker._run_losses(build_train_step(model, opt), st, inputs["batches"])
    return {"params": params, "state": state.opt_state, "losses": losses,
            "losses_fp32": losses_fp32}


@pytest.fixture(scope="module")
def results(worlds, reference, one_process):
    """Each mesh's results, one entry a rank."""
    out = {}
    for started in worlds.values():
        ranks = worker.collect(started)
        for mesh in ranks[0]:
            out[mesh] = [r[mesh] for r in ranks]
    return out


def test_moe_groups_of_the_global_batch(results):
    """phi3.5-moe (reduced): on (2, 1) each data shard holds whole groups of
    the global batch, on (2, 2) the two data shards split one group while
    each model rank runs two of the four experts; the losses (aux
    included) are the one-process run's on the same batches."""
    cfg = reduced_config(MOE)

    def one_process(seq):
        model = init_model(cfg, seed=0, device="cpu")
        opt = make_optimizer("production4bit", LR)
        return worker._run_steps(build_train_step(model, opt),
                                 make_train_state(model, opt, key=sr.PRNGKey(SEED)),
                                 _moe_batches(seq))

    want = one_process(16)
    for r in results["moe"]:
        np.testing.assert_allclose(r, want, rtol=1e-5)
    want = one_process(8)
    with worker._compute_dtype(torch.float32):
        want32 = one_process(8)
    got = results["moe_split"][0]
    print(f"(2, 2), a group split over the data shards: mesh {got}, one process {want}, fp32 "
          f"compute {want32}")
    for r in results["moe_split"]:
        assert r == got
    np.testing.assert_allclose(got["bf16"][0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got["bf16"][1], want[1], rtol=1e-4)
    np.testing.assert_allclose(got["fp32"], want32, rtol=1e-5)


def _torch_leaves(state):
    out = []
    for leaf in _leaves(state):
        out += [leaf.codes, *leaf.scales] if isinstance(leaf, QuantizedTensor) else [leaf]
    return out


def _jax_leaves(state):
    out = []
    for leaf in jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, JQ)):
        out += [leaf.codes, *leaf.scales] if isinstance(leaf, JQ) else [leaf]
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("mesh", [(2, 2), (2, 1), (1, 4)], ids=["2x2", "2x1", "1x4"])
def test_mesh_update_bit_equal_reference_and_one_process(mesh, results, reference,
                                                         one_process):
    ranks = results[mesh]
    res = ranks[0]
    for r in ranks[1:]:  # every rank gathers the same whole state
        for a, b in zip(_torch_leaves(r["opt_state"]), _torch_leaves(res["opt_state"])):
            assert torch.equal(a, b)
    got = _torch_leaves(res["opt_state"])
    want = _jax_leaves(reference["state"])
    mine = _torch_leaves(one_process["state"])
    assert len(got) == len(want) == len(mine)
    for i, (a, b, c) in enumerate(zip(got, want, mine)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b), err_msg=f"leaf {i}")
        assert torch.equal(a, c), i
    for k, p in res["params"].items():
        np.testing.assert_allclose(p.numpy(), reference["params"][k].numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
        assert torch.equal(p, one_process["params"][k]), k


@pytest.mark.parametrize("mesh", [(2, 2), (2, 1), (1, 4)], ids=["2x2", "2x1", "1x4"])
def test_mesh_step_losses_and_rank_layout(mesh, results, reference, one_process, inputs):
    ranks = results[mesh]
    for r in ranks:
        res = r
        np.testing.assert_allclose(res["losses"], reference["losses"], atol=2e-3)
        # a model-split mesh sums the bf16 gradients of its column-parallel
        # inputs over the model group, and that rounding reaches the 4-bit
        # update and the second loss; in fp32 compute the same run holds 1e-5
        np.testing.assert_allclose(res["losses"], one_process["losses"],
                                   rtol=1e-5 if mesh[1] == 1 else 3e-5)
        if mesh[1] > 1:
            np.testing.assert_allclose(res["losses_fp32"], one_process["losses_fp32"],
                                       rtol=1e-5)
        assert res["tile_shapes"] == res["want_shapes"]
        assert res["state_bytes"] == res["plan_bytes"]
    whole = sum(v.nbytes for v in inputs["params0"].values())
    held = sum(int(np.prod(s)) * 4 for s in ranks[0]["tile_shapes"].values())
    assert held < whole  # a part, not the whole


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_axes_equal_reference(arch):
    assert param_axes(reduced_config(arch)) == _ref_axes_of_arch(arch)

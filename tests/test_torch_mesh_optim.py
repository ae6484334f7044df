"""sm3, adafactor, factor4bit, shampoo32 and shampoo4bit on the port's
(data, model) mesh, against the reference and against the port in one
process.

Two spawned worlds (``torch_mesh_worker``'s ``optim`` task: (2, 2) and then
(1, 4) in 4 ranks, (2, 1) in 2; one thread a rank) run all five optimizers
on each mesh, and a world of one runs them in one process off the mesh
(``optim_one``), while the reference runs here. Reduced
internlm2-1.8b with the reference's params (``convert.py``) and its
gradients of two batches at them; shampoo4bit with SR. Held to:

* fed those gradients for 2 steps (Shampoo recomputes its roots on the
  first and reuses them on the second):
  - against the eager reference's ``opt.update``, within the bars of
    ``tests/test_torch_optimizers.py`` (bit-equal where no reduction
    enters, 1e-6 of the element or of the leaf's largest magnitude where a
    mean or a square root does, params within 1e-6) and of
    ``tests/test_torch_shampoo.py`` (factor codes bit-equal but the inverse
    roots', those at least 99% equal; statistics within 1e-6 and roots
    within 1e-5 of the leaf's largest magnitude; params within 1e-6, or no
    further than the one-process port's where it is further: shampoo4bit's
    are up to 1.8e-6 of a leaf's largest magnitude from the reference's);
  - against the port's one-process update: sm3 bit-equal (a max is
    exact); the others' floats within 1e-6 of the element or of the leaf's
    largest magnitude (the merged sums' order), every 4-bit code within one
    bin, the fraction that moved printed;
  - every rank gathers the same whole state;
* run end to end for 2 steps: losses within 2e-3 of the reference's loss
  jitted on its (2, 4) mesh at its params before and after its first
  update, and within 3e-5 of the port's one-process run (1e-5 on (1, 4)
  before its compute was split over the model axis): on the meshes that
  split the batch over data each half batch's weight gradient is rounded
  to bf16 by its product, on those that split the compute over the model
  axis the column-parallel inputs' bf16 gradients are summed over the
  model group, and these rules scale a gradient by statistics of its row,
  column or block, so the rounding reaches the update (fed the same
  gradients, the update holds 1e-6). The same runs in fp32 compute hold
  1e-5 on every mesh;
* each rank holds only its plan's parts, and its state bytes are its
  plan's;
* Shampoo's eigh work is split: each rank's first step computes a part of
  the one process's blocks, the distinct ranges adding up to all of them,
  and no rank holds a whole factor stack that its plan cuts;
* the meshes have leaves that the plan leaves whole on an axis (several
  ranks holding one box), whose sums count that box once.

Also here: B1's plain version on every tile of the (2, 2) plan against
the whole leaf's (``tests/test_torch_sharding.py``).
"""

import dataclasses
import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.models import loss_fn as j_loss  # noqa: E402
from repro.sharding import batch_shardings as j_batch_shardings  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.optimizers.adamw import M_4BIT, V_4BIT  # noqa: E402
from repro_torch.core.quantizer import quantize  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.io.tree import flatten_with_keys, structure_repr  # noqa: E402
from repro_torch.kernels import adamw4bit, ops, sr  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.specs import local_box  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402
from torch_ref import ref_params  # noqa: E402

ARCH, LR, SEED = "internlm2-1.8b", 1e-3, 0
OPTIMIZERS = (("sm3", {}), ("adafactor", {}), ("factor4bit", {}), ("shampoo32", {}),
              ("shampoo4bit", {"stochastic_rounding": True}))
NAMES = [n for n, _ in OPTIMIZERS]
MESHES = ((2, 2), (1, 4), (2, 1))
IDS = ["2x2", "1x4", "2x1"]
RTOL = 1e-6
# the reference's bars (tests/test_torch_optimizers.py): keys compared
# within RTOL, the rest bit for bit
CLOSE = {"sm3": (".m[",), "adafactor": (".row", ".col", ".m["), "factor4bit": (".row", ".col")}


@pytest.fixture(scope="module")
def inputs():
    """The reference's params (jitted init) and gradients of two batches at
    them."""
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


def _task(inputs, kind, meshes=()):
    return {"kind": kind, "arch": ARCH, "meshes": meshes, "optimizers": OPTIMIZERS, "lr": LR,
            "sr_seed": SEED, "params": inputs["params0"], "grads": inputs["grads_np"],
            "batches": inputs["batches"]}


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """A world of 4 ranks ((2, 2), then (1, 4)), one of 2 ((2, 1)) and one of
    a single process for the port off the mesh, started; they run while the
    reference computes here."""
    by_world = {4: ((2, 2), (1, 4)), 2: ((2, 1),)}
    out = {n: worker.start(n, {"optim": _task(inputs, "optim", meshes)},
                           str(tmp_path_factory.mktemp(f"world{n}")))
           for n, meshes in by_world.items()}
    out["one"] = worker.start(1, {"optim": _task(inputs, "optim_one")},
                              str(tmp_path_factory.mktemp("one")))
    return out


@pytest.fixture(scope="module")
def reference(inputs, worlds):
    """Per optimizer: the eager update fed the two gradients (params and
    state after both steps), and the losses of the loss jitted on the (2,
    4) mesh at the params before and after the first update."""
    cfg, p0 = inputs["cfg"], inputs["p"]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    batches = [jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                              j_batch_shardings(b, mesh)) for b in inputs["batches"]]
    loss = jax.jit(lambda p, b: j_loss(p, cfg, b)[0],
                   in_shardings=(NamedSharding(mesh, JP()), None))

    def fed(names):
        """The eager updates of ``names`` in turn: (params after the first
        step, params and state after both)."""
        got = {}
        for name in names:
            opt = j_make(name, LR, **dict(OPTIMIZERS)[name])
            p, s, steps = p0, opt.init(p0), []
            for t, g in enumerate(inputs["grads"]):
                p, s = opt.update(g, s, p, key=jax.random.fold_in(jax.random.PRNGKey(SEED), t))
                steps.append(p)
            got[name] = (steps[0], p, s)
        return got

    # eager JAX compiles every op for every new shape, and its compiles run
    # outside the GIL: the optimizers that share ops share a thread (the
    # second finds them compiled), the groups run side by side
    with ThreadPoolExecutor(4) as pool:
        fed_by = {}
        for part in pool.map(fed, (("shampoo4bit",), ("shampoo32",), ("adafactor", "factor4bit"),
                                   ("sm3",))):
            fed_by.update(part)
    base = float(loss(p0, batches[0]))
    return {name: {"params": params_from_jax(jax.device_get(p), "cpu"), "state": s,
                   "losses": [base, float(loss(p1, batches[1]))]}
            for name, (p1, p, s) in fed_by.items()}


@pytest.fixture(scope="module")
def one_process(worlds, reference):
    """The port in one process (its world of one, on one thread as each
    rank runs: LAPACK's eigh rounds by its thread count): its update fed
    the same gradients (with the eigh blocks of each step), and its
    end-to-end losses."""
    return worker.collect(worlds["one"])[0]["optim"]


@pytest.fixture(scope="module")
def results(worlds, one_process):
    """Each mesh's results, one entry a rank: ``{optimizer: result}``."""
    out = {}
    for n in (4, 2):
        ranks = worker.collect(worlds[n])
        for mesh in ranks[0]["optim"]:
            out[mesh] = [r["optim"][mesh] for r in ranks]
    return out


def _codes(x):
    return np.stack([x & 15, x >> 4]).astype(np.int16)


def _leaves(state):
    return [(k, v.numpy()) for k, v in flatten_with_keys(state)]


def _assert_like_reference(name, state, params, ref, one):
    """The bars the one-process port is held to against the reference; a
    parameter no further from the reference than the one-process port's
    (``one``) where that is further than the bar (shampoo4bit here: its
    inverse roots' codes part from the reference's on up to 1%)."""
    js = ref["state"]
    assert structure_repr(state) == str(jax.tree_util.tree_structure(js))
    jl = [(jax.tree_util.keystr(p), np.asarray(v))
          for p, v in jax.tree_util.tree_flatten_with_path(js)[0]]
    tl = _leaves(state)
    assert [k for k, _ in tl] == [k for k, _ in jl]
    shampoo = name.startswith("shampoo")
    for (k, a), (_, b) in zip(tl, jl):
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if shampoo and a.dtype == np.uint8 and "precond" in k:
            assert np.mean(_codes(a) == _codes(b)) >= 0.99, k
        elif shampoo and a.dtype != np.uint8 and ("precond" in k or "stats" in k):
            tol = (1e-5 if "precond" in k else 1e-6) * np.abs(b).max(initial=0.0)
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=k)
        elif any(s in k for s in CLOSE.get(name, ())):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max(), err_msg=k)
        else:
            np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                          b.reshape(-1).view(np.uint8), err_msg=k)
    for k, p in params.items():
        want = ref["params"][k].numpy()
        atol = max(1e-6 * np.abs(want).max() if shampoo else 1e-9,
                   np.abs(one["params"][k].numpy() - want).max())
        np.testing.assert_allclose(p.numpy(), want, rtol=RTOL, atol=atol, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_fed_updates_match_reference_and_one_process(mesh, results, reference, one_process):
    ranks = results[mesh]
    for name in NAMES:
        res, mine = ranks[0][name], one_process[name]
        for r in ranks[1:]:  # every rank gathers the same whole state
            for (_, a), (_, b) in zip(_leaves(r[name]["opt_state"]), _leaves(res["opt_state"])):
                np.testing.assert_array_equal(a, b)
        _assert_like_reference(name, res["opt_state"], res["params"], reference[name], mine)
        moved = {}
        for (k, a), (_, b) in zip(_leaves(res["opt_state"]), _leaves(mine["state"])):
            if name == "sm3":
                np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                              b.reshape(-1).view(np.uint8), err_msg=k)
            elif a.dtype == np.uint8:
                diff = np.abs(_codes(a) - _codes(b))
                assert diff.max(initial=0) <= 1, k
                if diff.any():
                    moved[k] = float(np.mean(diff > 0))
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max(initial=0),
                                           err_msg=k)
        print(f"{mesh} {name}: 4-bit codes moved one bin against one process: {moved}")
        for k, p in res["params"].items():
            want = mine["params"][k]
            if name == "sm3":
                assert torch.equal(p, want), k
            else:
                np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=RTOL,
                                           atol=RTOL * float(want.abs().max()), err_msg=k)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_end_to_end_losses(mesh, results, reference, one_process):
    got = {name: np.array([r[name]["losses"] for r in results[mesh]]) for name in NAMES}
    to_ref = {n: float(np.abs(g - reference[n]["losses"]).max()) for n, g in got.items()}
    to_one = {n: float(np.abs(g / one_process[n]["losses"] - 1).max()) for n, g in got.items()}
    print(f"{mesh} end-to-end losses: from the reference {to_ref}, from one process {to_one}")
    assert max(to_ref.values()) <= 2e-3, to_ref
    # a data-split mesh sums the weight gradients of half batches, each
    # rounded to bf16 by its product, and a model-split mesh sums the bf16
    # gradients of its column-parallel inputs over the model group; sm3,
    # adafactor and Shampoo scale a gradient by statistics of its row,
    # column or block (not of itself, as AdamW's first step does), so that
    # rounding reaches the update and the loss. In fp32 compute the same
    # runs hold 1e-5
    assert all(v <= 3e-5 for v in to_one.values()), to_one
    if mesh != (1, 1):
        fp32 = {n: float(np.abs(np.array([r[n]["losses_fp32"] for r in results[mesh]])
                                / one_process[n]["losses_fp32"] - 1).max()) for n in NAMES}
        print(f"{mesh} fp32 compute, from one process: {fp32}")
        assert all(v <= 1e-5 for v in fp32.values()), fp32


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_rank_layout_and_state_bytes(mesh, results):
    for r in results[mesh]:
        for name in NAMES:
            res = r[name]
            assert res["state_bytes"] == res["plan_bytes"], name
            for held, box, whole in res["held"]:  # this rank's plan box of every tensor
                assert held == tuple(b - a for a, b in box), (name, held, box, whole)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_shampoo_eigh_split_and_stacks_cut(mesh, results, one_process):
    ranks = results[mesh]
    for name in ("shampoo32", "shampoo4bit"):
        whole = one_process[name]["eigh_blocks"]
        assert whole[0] > 0 and whole[1] == 0  # roots at step 1, reused at step 2
        per_rank = [r[name]["eigh_blocks"] for r in ranks]
        assert all(0 < b[0] < whole[0] and b[1] == 0 for b in per_rank), per_rank
        assert sum(b[0] for b in per_rank) >= whole[0]
        # each leaf's distinct ranges of whole blocks tile its stack, and some
        # leaf is split
        ranges = ranks[0][name]["block_ranges"]
        for rg in ranges.values():
            assert rg[0][0] == 0 and all(a[1] == b[0] for a, b in zip(rg, rg[1:])), rg
        assert any(len(rg) > 1 for rg in ranges.values())
        # where the plan cuts the stacks (over data), no rank holds one whole
        for r in ranks:
            for k, f, held, whole_shape in r[name]["stacks"]:
                assert (held != whole_shape) == (mesh[0] > 1), (k, f, held, whole_shape)


def test_meshes_hold_boxes_on_several_ranks(results):
    """(2, 2) has parameters that several ranks hold one box of (the plan
    leaves them whole on an axis: a 1-d norm scale is cut over model and
    replicated over data), whose sums must count that box once; the
    comparisons above cover them."""
    shared = results[(2, 2)][0]["sm3"]["shared_boxes"]
    assert any("norm" in k for k in shared), shared


@pytest.mark.parametrize("use_sr", [False, True])
def test_b1_plain_on_tiles_equals_whole_leaf(use_sr):
    """Every tile of the (2, 2) plan of reduced internlm2's ``mlp/w1`` (4, 64,
    256): pass 1 per tile, the per-dim maxima merged (max), pass 2 per tile
    with the tile's offsets and seed rows -> the whole leaf's result at the
    tile, bit for bit."""
    shape, axes = (4, 64, 256), ("layers", "embed", "mlp")
    sizes = {"data": 2, "model": 2}
    spec = rules.wire_spec(shape, axes, sizes)
    assert tuple(spec) == (None, "data", "model")
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    g = torch.from_numpy((rng.normal(size=shape) * 0.1).astype(np.float32))
    mc = dataclasses.replace(M_4BIT, stochastic_rounding=use_sr)
    vc = dataclasses.replace(V_4BIT, stochastic_rounding=use_sr)
    m_s = quantize(torch.from_numpy((rng.normal(size=shape) * 0.01).astype(np.float32)), mc)
    v_s = quantize(torch.from_numpy((np.abs(rng.normal(size=shape)) * 1e-3).astype(np.float32)),
                   vc)
    key = sr.PRNGKey(3) if use_sr else None
    hp = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              bc1=np.float32(0.19), bc2=np.float32(0.001999))
    whole_w = w.clone()
    _, m2, v2 = ops.fused_adamw4_leaf(whole_w, g, m_s, v_s, **hp, key=key)

    L, R, C = shape
    tiles = [local_box(spec, shape, dict(zip(sizes, c)), sizes)
             for c in itertools.product(range(2), range(2))]
    parts = []
    for box in tiles:  # pass 1 per tile
        idx = tuple(slice(a, b) for a, b in box)
        (r0, r1), (c0, c1) = box[1], box[2]
        v_r, v_c = ops._rank1_slice_stats(tuple(s[a:b] for s, (a, b) in zip(v_s.scales, box)),
                                          (L, r1 - r0, c1 - c0))
        parts.append(adamw4bit.rank1_new_stats(
            v_s.codes[idx[0], idx[1], c0 // 2:c1 // 2].contiguous(), v_r.contiguous(),
            v_c.contiguous(), g[idx].contiguous(), vc.table("cpu"), hp["b2"],
            (L, r1 - r0, c1 - c0)))
    merged = []
    for d, n in enumerate(shape):  # the max-merge over the tiles
        full = torch.zeros(n)
        for box, st in zip(tiles, parts):
            full[box[d][0]:box[d][1]] = torch.maximum(full[box[d][0]:box[d][1]], st[d])
        merged.append(full)
    for a, b in zip(merged, v2.scales):
        assert torch.equal(a, b)
    seeds = ops.seed_rows(key, L) if use_sr else None
    for box in tiles:  # pass 2 per tile
        idx = tuple(slice(a, b) for a, b in box)
        (r0, r1), (c0, c1) = box[1], box[2]
        tshape = (L, r1 - r0, c1 - c0)
        old = [tuple(s[a:b] for s, (a, b) in zip(st, box)) for st in (v_s.scales, merged)]
        (v_r, v_c), (v_rn, v_cn) = (ops._rank1_slice_stats(o, tshape) for o in old)
        ms = m_s.scales[0].reshape(L, R, C // 128)[:, r0:r1, c0 // 128:c1 // 128]
        w_t, mp, mscale, vp = adamw4bit.fused_adamw4(
            w[idx].contiguous(), g[idx].contiguous(),
            m_s.codes[idx[0], idx[1], c0 // 2:c1 // 2].contiguous(), ms.contiguous(),
            v_s.codes[idx[0], idx[1], c0 // 2:c1 // 2].contiguous(), v_r.contiguous(),
            v_c.contiguous(), v_rn.contiguous(), v_cn.contiguous(), mc.table("cpu"),
            vc.table("cpu"), hp["lr"], hp["bc1"], hp["bc2"], seeds,
            b1=hp["b1"], b2=hp["b2"], eps=hp["eps"], weight_decay=hp["weight_decay"],
            use_sr=use_sr, tile=(r0, c0, C))
        assert torch.equal(w_t, whole_w[idx])
        assert torch.equal(mp, m2.codes[idx[0], idx[1], c0 // 2:c1 // 2])
        assert torch.equal(vp, v2.codes[idx[0], idx[1], c0 // 2:c1 // 2])
        assert torch.equal(mscale, m2.scales[0].reshape(L, R, C // 128)[:, r0:r1,
                                                                         c0 // 128:c1 // 128])

"""The port's dry run (``repro_torch.launch.dryrun``) and input specs
(``launch.specs``) against the reference.

* ``input_specs`` of every arch × shape has the reference's leaves, shapes
  and dtypes; ``serve_cache_specs`` at decode_32k and long_500k (where
  runnable) equals the reference's ``eval_shape`` leaf for leaf;
  ``decode_cache_len`` is equal.
* Over (data=16, model=16) and (pod=2, data=16, model=16), every runnable
  cell's ``param_bytes`` equals the per-device bytes of the reference's
  ``spec_for`` / ``with_zero`` on a duck-typed mesh (shard shapes from the
  partition; training's fp32 masters with ZeRO, serving's bf16 weights).
* On a (data=2, model=4) mapping with a reduced config, ``dry_run``'s
  ``state_bytes`` equals the largest per-device sum of the reference's
  ``addressable_shards`` on the 8-device harness.
* ``run_all`` over xlstm-125m and internlm2-1.8b on the single-pod plan
  writes 8 records (1 skipped, none in error) and a second call adds none;
  the CLI prints one record (``tests/test_torch_dryrun_all.py``, a file of
  its own: the longest test of the port's files).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import cell_is_runnable as j_runnable  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.sharding import rules as j_rules  # noqa: E402
from repro.sharding.specs import opt_state_shardings as j_plan  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, cell_is_runnable  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.models import init_model, named_params, param_axes  # noqa: E402
from repro_torch.models.model import cache_leaves  # noqa: E402
from repro_torch.sharding.specs import mesh_coords, param_shardings, plan_nbytes  # noqa: E402
from test_torch_sharding import FakeMesh  # noqa: E402


def _spec_leaves(tree):
    """(shape, dtype name) of every tensor of a port spec tree, in order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if k == "caches":
            out += [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                    for t in cache_leaves(v)]
        else:
            out.append((tuple(v.shape), str(v.dtype).replace("torch.", "")))
    return out


def _ref_leaves(tree):
    out = []
    for k in sorted(tree):
        out += [(tuple(l.shape), str(l.dtype)) for l in jax.tree_util.tree_leaves(tree[k])]
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_and_cache_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, shape in SHAPES.items():
        jshape = J_SHAPES[name]
        assert specs.decode_cache_len(cfg, shape) == j_specs.decode_cache_len(jcfg, jshape)
        if shape.kind == "decode" and not cell_is_runnable(arch, name)[0]:
            continue
        got, want = specs.input_specs(cfg, shape), j_specs.input_specs(jcfg, jshape)
        assert sorted(got) == sorted(want), (arch, name)
        assert _spec_leaves(got) == _ref_leaves(want), (arch, name)
        for t in (cache_leaves(got["caches"]) if "caches" in got else got.values()):
            assert t.device.type == "meta"


def _ref_param_bytes(arch, mesh, train):
    """Per-device bytes of the reference's params under its rules: shard
    shapes from the partition (every rank holds equal parts)."""
    out = {}

    def capture():
        p, out["axes"] = j_init(jax.random.PRNGKey(0), j_get_config(arch))
        return p

    params = jax.eval_shape(capture)
    is_axes = lambda a: isinstance(a, tuple) and all(isinstance(s, str) for s in a)
    fake = FakeMesh(mesh)
    total = 0
    for p, a in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(out["axes"], is_leaf=is_axes)):
        shape = tuple(p.shape)
        spec = j_rules.spec_for(shape, a, fake)
        if train:
            spec = j_rules.with_zero(shape, spec, fake, axes=a)
        n = 1
        for d, size in enumerate(shape):
            e = spec[d] if d < len(spec) else None
            k = 1
            for ax in (() if e is None else e if isinstance(e, tuple) else (e,)):
                k *= mesh[ax]
            n *= size // k
        total += n * (4 if train else 2)
    return total


@pytest.mark.parametrize("mesh_kind", list(dryrun.MESHES))
def test_param_bytes_equal_reference_rules(mesh_kind):
    mesh = dryrun.MESHES[mesh_kind]
    want = {}
    n = 0
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            runnable = cell_is_runnable(arch, name)[0]
            assert runnable == j_runnable(arch, name)[0]
            if not runnable:
                continue
            rec = dryrun.memory_record(get_config(arch), shape, mesh)
            assert rec["status"] == "ok", (arch, name, rec.get("reason"))
            train = shape.kind == "train"
            if (arch, train) not in want:
                want[arch, train] = _ref_param_bytes(arch, mesh, train)
            assert rec["memory"]["param_bytes"] == want[arch, train], (arch, name)
            mem = rec["memory"]
            assert mem["argument_bytes"] == sum(mem[k] for k in ("param_bytes", "state_bytes",
                                                                 "batch_bytes", "cache_bytes"))
            assert ("gathered_layer_bytes" in mem) == train
            n += 1
    assert n == 33  # 40 cells of a mesh, 7 skipped
    # every rank holds the same bytes: the record's are the largest over the ranks
    cfg, shape = get_config("mixtral-8x7b"), SHAPES["train_4k"]
    params = {k: p.detach() for k, p in named_params(init_model(cfg, device="meta")).items()}
    plan = param_shardings(params, param_axes(cfg), mesh, zero=True)
    every = {plan_nbytes(params, plan, c, mesh) for c in mesh_coords(mesh)}
    assert every == {dryrun.memory_record(cfg, shape, mesh)["memory"]["param_bytes"]}


@pytest.mark.parametrize("opt_name", ["adamw4bit", "production4bit", "factor4bit", "shampoo4bit"])
def test_state_bytes_equal_reference_addressable_shards(opt_name):
    arch = "internlm2-1.8b"
    out = {}

    def capture():
        p, out["axes"] = j_init(jax.random.PRNGKey(0), j_reduced(arch))
        return p

    # the bytes a device holds depend on shapes alone: zeros of the state's
    # shapes, placed by the reference's plan
    jparams = jax.eval_shape(capture)
    shapes = jax.eval_shape(j_make(opt_name, 1e-3).init, jparams)
    jstate = jax.tree_util.tree_map(lambda s: jax.numpy.zeros(s.shape, s.dtype), shapes)
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    placed = jax.device_put(jstate, j_plan(jstate, jparams, out["axes"], mesh))
    per_device = {}
    for leaf in jax.tree_util.tree_leaves(placed):
        for sh in leaf.addressable_shards:
            per_device[sh.device] = per_device.get(sh.device, 0) + sh.data.nbytes
    rec = dryrun.dry_run(reduced_config(arch), ShapeSpec("small", 32, 8, "train"),
                         {"data": 2, "model": 4}, opt_name, accum_steps=2)
    assert rec["status"] == "ok"
    assert rec["memory"]["state_bytes"] == max(per_device.values())
    assert rec["n_chips"] == 8 and rec["rank_batch"] == 4
    assert rec["collectives"]["result_bytes"] > 0 and rec["compute_split"] == "data+model"


def test_refusals_carry_the_mesh_steps_message():
    shape = ShapeSpec("small", 32, 8, "train")
    # an optimizer whose rules need whole-leaf statistics is no refusal
    rec = dryrun.dry_run(reduced_config("internlm2-1.8b"), shape, {"data": 2, "model": 1},
                         "sm3", accum_steps=1)
    assert rec["status"] == "ok"
    # 8 x 16 tokens of reduced phi3.5 (groups of 64) split over 4 data shards:
    # the groups span shards, whose routing counts are gathered over the data
    # group (no refusal); 8 x 12 tokens do not split into groups of 64
    phi = reduced_config("phi3.5-moe-42b-a6.6b")
    rec = dryrun.dry_run(phi, ShapeSpec("small", 16, 8, "train"), {"data": 4, "model": 1},
                         accum_steps=1)
    assert rec["status"] == "ok" and rec["collectives"]["result_bytes"] > 0
    rec = dryrun.dry_run(phi, ShapeSpec("small", 12, 8, "train"), {"data": 4, "model": 1},
                         accum_steps=1)
    assert rec["status"] == "refused" and "do not split into groups of 64" in rec["reason"]

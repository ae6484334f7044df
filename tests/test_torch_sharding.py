"""The port's sharding against the reference: the logical-axes tree, the
rules (``spec_for``, ``with_zero``, ``wire_spec``), the optimizer-state
plans of all eleven optimizers, the bytes each rank holds, and B1's plain
version on a plan's tiles.

Held to: the axes tree equal for all 10 archs (the reference's
``init_model`` traced at the reduced configs); the rules' partitions equal on every
leaf of every arch's full config (shapes from a ``meta`` model) under the
(16, 16), (2, 16, 16), (2, 4) and (4, 2) meshes (a duck-typed mesh, as
``tests/test_roofline.py`` does); the state plans equal to the reference's
``NamedSharding.spec`` leaf by leaf on a (2, 4) host mesh; each device's
bytes of production4bit state on (2, 4) (the sum of its
``addressable_shards``) equal to the port's plan bytes at that
coordinate; and B1's plain version on every tile of the (2, 2) plan, with
offsets and max-merged stats, bit-equal to the whole leaf's, RTN and SR.

The axes trees are held in ``tests/test_torch_mesh.py`` and B1's tiles in
``tests/test_torch_mesh_optim.py`` (pytest-xdist's ``--dist loadfile``
hands out the files with the most tests first).
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.sharding import rules as j_rules  # noqa: E402
from repro.sharding.specs import opt_state_shardings as j_plan  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer, optimizer_names  # noqa: E402
from repro_torch.io.tree import flatten_with_keys  # noqa: E402
from repro_torch.models import init_model, named_params, param_axes  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.specs import (  # noqa: E402
    opt_state_shardings,
    param_shardings,
    plan_leaves,
    plan_nbytes,
)

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}, {"data": 4, "model": 2}]


class FakeMesh:
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


def _is_axes(a):
    return isinstance(a, tuple) and all(isinstance(s, str) for s in a)


def _ref_axes(arch):
    # traced, not run: the axes are Python tuples that the trace hands back
    out = {}

    def init():
        params, out["axes"] = j_init(jax.random.PRNGKey(0), j_reduced(arch))
        return params

    jax.eval_shape(init)
    flat, _ = jax.tree_util.tree_flatten_with_path(out["axes"], is_leaf=_is_axes)
    key = lambda p: "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
    return {key(p): a for p, a in flat}


def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("sizes", MESHES, ids=["16x16", "2x16x16", "2x4", "4x2"])
def test_rules_equal_reference_on_full_configs(sizes):
    fake = FakeMesh(sizes)
    assert rules.TP_RULES == j_rules.TP_RULES and rules.NEVER_SHARD == j_rules.NEVER_SHARD
    assert rules.dp_axes(sizes) == j_rules.dp_axes(fake)
    assert rules.dp_size(sizes) == j_rules.dp_size(fake)
    n = 0
    for arch in ARCHS:
        cfg = get_config(arch)
        axes = param_axes(cfg)
        for path, p in named_params(init_model(cfg, device="meta")).items():
            shape, a = tuple(p.shape), axes[path]
            spec = rules.spec_for(shape, a, sizes)
            want = j_rules.spec_for(shape, a, fake)
            assert _pad(spec, len(shape)) == _pad(want, len(shape)), (arch, path)
            for ax in (a, None):
                assert _pad(rules.with_zero(shape, spec, sizes, axes=ax), len(shape)) == \
                    _pad(j_rules.with_zero(shape, want, fake, axes=ax), len(shape)), (arch, path)
            # the wire layout of the gradient and of its packed int4 codes
            codes = shape[:-1] + (max(shape[-1] // 2, 1),)
            for s in (shape, codes):
                assert _pad(rules.wire_spec(s, a, sizes), len(s)) == \
                    _pad(j_rules.wire_spec(s, a, fake), len(s)), (arch, path, s)
            n += 1
    assert n > 250


@pytest.fixture(scope="module")
def internlm2():
    cfg = j_reduced("internlm2-1.8b")
    jparams, jaxes = j_init(jax.random.PRNGKey(0), cfg)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    return jparams, jaxes, params, param_axes(reduced_config("internlm2-1.8b"))


@pytest.mark.parametrize("name", list(optimizer_names()))
def test_opt_state_plans_equal_reference(internlm2, name):
    jparams, jaxes, params, axes = internlm2
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    jstate = jax.eval_shape(lambda: j_make(name, 1e-3).init(jparams))  # shapes suffice
    want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(j_plan(jstate, jparams, jaxes, mesh))]
    state = make_optimizer(name, 1e-3).init(params)
    for zero in (True, False):
        plan = opt_state_shardings(state, params, axes, {"data": 2, "model": 4}, zero=zero)
        got = [(t, spec) for t, spec in plan_leaves(state, plan)]
        ref = want if zero else [tuple(s.spec) for s in jax.tree_util.tree_leaves(
            j_plan(jstate, jparams, jaxes, mesh, zero=False))]
        keys = [k for k, _ in flatten_with_keys(state)]
        assert len(got) == len(ref) == len(keys)
        for k, (t, spec), w in zip(keys, got, ref):
            assert _pad(spec, t.dim()) == _pad(w, t.dim()), (name, zero, k)


def test_param_plan_equal_reference(internlm2):
    from repro.sharding.specs import param_shardings as j_param_plan

    jparams, jaxes, params, axes = internlm2
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    for zero in (True, False):
        # the port's mappings are in the reference's leaf order
        want = [tuple(v.spec) for v in
                jax.tree_util.tree_leaves(j_param_plan(jparams, jaxes, mesh, zero=zero))]
        got = param_shardings(params, axes, {"data": 4, "model": 2}, zero=zero)
        assert len(got) == len(want)
        for (k, spec), w in zip(got.items(), want):
            assert _pad(spec, params[k].dim()) == _pad(w, params[k].dim()), (zero, k)


def test_rank_bytes_equal_reference_addressable_shards(internlm2):
    """production4bit state placed on the (2, 4) host mesh: every device's
    shard bytes equal the port's plan bytes at its coordinate."""
    jparams, jaxes, params, axes = internlm2
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    jstate = j_make("production4bit", 1e-3).init(jparams)
    placed = jax.device_put(jstate, j_plan(jstate, jparams, jaxes, mesh))
    per_device = {}
    for leaf in jax.tree_util.tree_leaves(placed):
        for sh in leaf.addressable_shards:
            per_device[sh.device] = per_device.get(sh.device, 0) + sh.data.nbytes
    state = make_optimizer("production4bit", 1e-3).init(params)
    sizes = {"data": 2, "model": 4}
    plan = opt_state_shardings(state, params, axes, sizes)
    seen = set()
    for (i, j), dev in np.ndenumerate(mesh.devices):
        got = plan_nbytes(state, plan, {"data": i, "model": j}, sizes)
        assert got == per_device[dev], (i, j)
        seen.add(got)
    assert len(seen) == 1  # an even plan: every rank holds the same bytes
    whole = sum(t.numel() * t.element_size() for t, _ in plan_leaves(state, plan))
    assert whole > 2 * next(iter(seen))

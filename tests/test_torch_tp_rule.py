"""The placement rule of the port's tensor-parallel compute
(``sharding.tensor_parallel.placement``), structurally, and the mesh that
splits nothing.

(a) For all 10 archs' full configs on (1, 2), (1, 4), (2, 2), (1, 16) and
(16, 16), on ``meta``: which leaves compute tensor-parallel and which are
gathered whole, every cut taken from the reference's ``spec_for``
(``repro/sharding/rules.py``, given the mesh's axis sizes): an attention
splits its heads where ``wq`` and ``wo`` are cut on ``heads`` (and ``wk``/
``wv`` where they are cut on ``kv_heads``) and is row-parallel where
``wq`` and ``wo`` are cut on ``embed`` (``wk``/``wv`` wherever they are
cut), an MLP its columns where ``w1``/``w3``/``w2`` are cut on ``mlp``, an
MoE layer its experts where its ``w1``/``w3``/``w2`` are cut on
``experts`` and else each expert's columns where they are cut on ``mlp``,
``embed`` and ``head`` wherever they are cut (their vocabulary, else their
width), a recurrent block's own leaves (mLSTM, sLSTM, hymba's SSM heads)
wherever they are cut; everything else (norms, MoE routers, hymba's
``scale_attn``/``scale_ssm``) is gathered. Named cases: chatglm3-6b's 2 kv
heads on 4 ranks and internlm2-1.8b's 8 on 16 (kv weights gathered, cut on
``embed`` by the reference), hymba-1.5b's 25 heads (its attention
row-parallel, its vocabulary of 32,001 cut on the width, its MLP split, its
SSM cut on its states and ``ssm_dt`` on its rows), whisper-large-v3's 20
heads on 16 (row-parallel) and on 4 (head-parallel, its vocabulary of
51,866 cut on the width).
GQA: the kv heads a rank's q heads read (``kv_heads``) are its own slice
wherever the model axis divides the kv heads, and map every q head onto
its kv head (``h // G``) wherever it does not.

(e) A mesh with ``model = 1``, such as (2, 1), splits nothing: no leaf is
placed, the step holds no model group, its reckoning needs no batch and
records no model-group sum, and its step runs none (the (2, 1) step is the
data-parallel step of before; its end-to-end bars are
``tests/test_torch_mesh.py``'s).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sharding.rules import spec_for as j_spec_for  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.models import init_model, named_params, param_axes  # noqa: E402
from repro_torch.sharding import tensor_parallel as T  # noqa: E402
from repro_torch.sharding.context import MeshRun  # noqa: E402
from repro_torch.train.mesh import MeshStep  # noqa: E402

MESHES = ((1, 2), (1, 4), (2, 2), (1, 16), (16, 16))
# the recurrent blocks' own leaves (the reference's _init_mlstm, _init_slstm,
# _init_hymba) but their norms and hymba's scales
RECURRENT = {"w_in", "wq", "wk", "wv", "w_if", "b_if", "w_out", "w_gates", "r_gates", "ssm_in",
             "ssm_dt", "ssm_dt_bias", "ssm_B", "ssm_C", "ssm_A_log", "ssm_D", "ssm_out"}


def _fake_mesh(shape):
    """What the reference's ``spec_for`` reads of a mesh: its axis names and
    the shape of its device array."""
    return types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty(shape))


def _ref_cut(shape, axes, mesh):
    """The dim the reference's ``spec_for`` gives the model axis, or None."""
    spec = tuple(j_spec_for(tuple(shape), tuple(axes), _fake_mesh(mesh)))
    dims = [d for d, e in enumerate(spec) if e == "model"]
    return dims[0] if dims else None


def _expected(shapes, axes, mesh):
    """The placement rule, from the reference's cuts."""
    cut = {k: _ref_cut(s, axes[k], mesh) for k, s in shapes.items()}
    on = lambda k, name: k in cut and cut[k] is not None and axes[k][cut[k]] == name
    want = dict.fromkeys(shapes)
    for k in shapes:
        *parent, leaf = k.split("/")
        parent = "/".join(parent)
        sub = parent.rsplit("/", 1)[-1] if parent else ""
        if sub in ("attn", "self", "cross"):
            heads = on(f"{parent}/wq", "heads") and on(f"{parent}/wo", "heads")
            rows = on(f"{parent}/wq", "embed") and on(f"{parent}/wo", "embed")
            if heads and (leaf in ("wq", "wo") or (leaf in ("wk", "wv")
                                                   and on(k, "kv_heads"))):
                want[k] = cut[k]
            elif rows and leaf in ("wq", "wo", "wk", "wv"):
                want[k] = cut[k]
        elif sub == "mlp":
            names = [n for n in ("w1", "w3", "w2") if f"{parent}/{n}" in shapes]
            if all(on(f"{parent}/{n}", "mlp") for n in names):
                want[k] = cut[k]
        elif sub == "moe" and leaf != "router":
            if any(all(on(f"{parent}/{n}", axis) for n in ("w1", "w3", "w2"))
                   for axis in ("experts", "mlp")):
                want[k] = cut[k]
        elif k in ("embed", "head"):
            want[k] = cut[k]
        elif sub.startswith("sub") and leaf in RECURRENT:
            want[k] = cut[k]
    return want


def _shapes(cfg):
    return {k: tuple(p.shape) for k, p in named_params(init_model(cfg, device="meta")).items()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_placement_follows_the_references_cuts(arch):
    cfg = get_config(arch)
    shapes, axes = _shapes(cfg), param_axes(cfg)
    for mesh in MESHES:
        sizes = dict(zip(("data", "model"), mesh))
        got = T.placement(shapes, axes, sizes)
        assert got == _expected(shapes, axes, mesh), (arch, mesh)
        split = [k for k, d in got.items() if d is not None]
        # a split leaf is cut on its model dim by the reference, its shard whole
        for k in split:
            assert shapes[k][got[k]] % mesh[1] == 0
        # never split: norms, MoE routers, hymba's scales
        assert not any(k.endswith(("/moe/router", "/scale_attn", "/scale_ssm"))
                       or "norm" in k.rsplit("/", 1)[-1] for k in split), split
        print(f"{arch} {mesh}: {len(split)} leaves split, {len(got) - len(split)} gathered")


def _kv_of(arch, mesh):
    cfg = get_config(arch)
    got = T.placement(_shapes(cfg), param_axes(cfg), dict(zip(("data", "model"), mesh)))
    return {k.rsplit("/", 1)[-1]: d for k, d in got.items() if "/attn/" in k}, got


def test_named_cases():
    kv, _ = _kv_of("chatglm3-6b", (1, 4))  # 2 kv heads on 4: kv gathered, heads split
    assert kv["wq"] == 2 and kv["wo"] == 1 and kv["wk"] is None and kv["wv"] is None
    assert _ref_cut((28, 4096, 2, 128), ("layers", "embed", "kv_heads", "head_dim"),
                    (1, 4)) == 1  # the reference cuts them on embed
    for mesh in ((1, 16), (16, 16)):  # internlm2's 8 kv heads on 16
        kv, got = _kv_of("internlm2-1.8b", mesh)
        assert kv["wq"] == 2 and kv["wk"] is None and got["embed"] == 0 and got["head"] == 1
    kv, _ = _kv_of("internlm2-1.8b", (1, 4))
    assert kv["wk"] == 2 and kv["wv"] == 2
    # 25 heads: attention row-parallel (every weight on its embed dim), mlp split
    attn, got = _kv_of("hymba-1.5b", (1, 2))
    assert (attn["wq"], attn["wk"], attn["wv"], attn["wo"]) == (1, 1, 1, 3)
    assert all(d is not None for k, d in got.items() if "/mlp/" in k)
    assert got["embed"] == 1 and got["head"] == 0  # 32001 rows: cut on the width
    # its SSM: B and C on their 16 states, dt on its rows, the per-head
    # vectors and the scales whole
    ssm = {k.rsplit("/", 1)[-1]: d for k, d in got.items() if k.startswith("decoder/0/sub0/")}
    assert (ssm["ssm_in"], ssm["ssm_dt"], ssm["ssm_B"], ssm["ssm_C"], ssm["ssm_out"]) == (
        2, 1, 3, 3, 1)
    assert ssm["ssm_D"] is ssm["ssm_A_log"] is ssm["scale_ssm"] is None
    whisper = T.placement(_shapes(get_config("whisper-large-v3")),
                          param_axes(get_config("whisper-large-v3")), {"data": 1, "model": 16})
    # 20 heads on 16: every attention row-parallel, its vocabulary on the width
    assert all(d == (3 if k.endswith("/wo") else 1) for k, d in whisper.items()
               if "/self/" in k or "/cross/" in k or "/attn/" in k)
    assert whisper["embed"] == 1
    whisper4 = T.placement(_shapes(get_config("whisper-large-v3")),
                           param_axes(get_config("whisper-large-v3")), {"data": 1, "model": 4})
    assert all(d is not None for k, d in whisper4.items()
               if k.endswith(("/self/wq", "/cross/wo", "encoder/0/sub0/attn/wq")))
    assert whisper4["encoder/0/sub0/attn/wq"] == 2 and whisper4["embed"] == 1


@pytest.mark.parametrize("heads,kv", [(16, 8), (32, 2), (12, 2), (12, 4), (25, 5)])
def test_gqa_kv_heads_of_a_ranks_q_heads(heads, kv):
    group = heads // kv
    for M in (2, 3, 4, 8, 16):
        if heads % M:
            continue
        n = heads // M
        for m in range(M):
            idx = T.kv_heads(m * n, n, heads, kv)
            if isinstance(idx, slice):
                k = idx.stop - idx.start
                local = [idx.start + i // (n // k) for i in range(n)]
            else:
                local = idx
            assert local == [(m * n + i) // group for i in range(n)], (heads, kv, M, m)
            if kv % M == 0:  # the rank's own kv slice
                assert idx == slice(m * kv // M, (m + 1) * kv // M)


def test_model_axis_of_one_splits_nothing():
    for arch in ARCHS:
        cfg = get_config(arch)
        assert all(d is None for d in T.placement(_shapes(cfg), param_axes(cfg),
                                                  {"data": 2, "model": 1}).values())
    cfg = reduced_config("internlm2-1.8b")
    meta = {k: p.detach() for k, p in named_params(init_model(cfg, device="meta")).items()}
    opt = make_optimizer("production4bit", 1e-3)
    state = opt.init(meta)
    run = MeshRun({"data": 2, "model": 1}, rank=1)
    assert run.n_tp == 1 and run.model_group is None and run.model_ranks == [1]
    ms = MeshStep(run, cfg, {k: tuple(p.shape) for k, p in meta.items()}, param_axes(cfg),
                  meta, state)
    assert ms.tp is None
    # the walk of before: no batch, and every call over the world or the data group
    from repro_torch.roofline.measured import Counter
    from repro_torch.sharding.specs import local_slice, map_plan

    cut = lambda t, spec: local_slice(t, spec, run.coord, run.sizes).clone()
    with Counter():
        _, calls = ms.reckon({k: cut(p, ms.param_plan[k]) for k, p in meta.items()},
                             map_plan(cut, state, ms.state_plan), opt)
    assert {size for _, _, size in calls} <= {1, 2}

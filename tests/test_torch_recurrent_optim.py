"""The optimizers on the port's recurrent archs (xlstm-125m, hymba-1.5b)
against the JAX reference: production4bit bit for bit, the full-size
routes, and the structural byte counts.

* The optimizer alone, eager on both sides (jitted JAX contracts FMAs, the
  port does not): three production4bit SR updates from the reference's
  params and the same seeded gradients, on small trees that take the
  full-size archs' routes: an xLSTM of width 256 (``w_in``, ``w_out``,
  ``w_gates`` as 256 slices of 4 x 256, and the sLSTM's ``w_out`` and
  ``mlp/w2`` through B1; ``wq``/``wk``/``wv``, the 5-D ``r_gates`` and the
  384-wide ``mlp/w1``/``w3`` 4-bit and unfused; ``w_if`` and ``b_if``
  under the 4096-element threshold) and a hymba of width 416 and 13 heads
  (nothing fused; ``ssm_dt`` a 3-D unfused leaf, as ``w_if`` is at full
  size, with an odd last dim and a size that is no multiple of 128). Every
  state leaf bit-equal (codes, scales, step counts, fp32 moments), params
  within 1e-6 relative, labels equal.
* Labels, B1 routes and the elements of each route at full size (meta
  tensors): xlstm-125m 11 fused leaves of 31,850,496 elements, 17,750,016
  unfused 4-bit, 77,279,232 fp32; hymba-1.5b none fused, 1,330,115,200
  unfused 4-bit (no last dim is a multiple of 256), 102,507,200 fp32;
  ``scale_attn``/``scale_ssm`` are 4-bit (no fp32 regex matches them).

(``tests/test_torch_recurrent_train.py`` holds the structural byte counts.)

Also here, with ``tests/test_torch_recurrent.py``'s bars: ``gla_decode_step``,
``slstm_scan``, the recurrent constants, the bf16 cotangents and the
padded prefill against its decode oracle.
"""

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.core.optimizers.presets import production_labels as j_labels  # noqa: E402
from repro.core.optimizers.schedule import linear_warmup_linear_decay as j_sched  # noqa: E402
from repro.core.quantizer import QuantizedTensor as JQ  # noqa: E402
from repro.models import (  # noqa: E402
    gla as j_gla,
    LayerSpec as JLayerSpec,
    ModelConfig as JModelConfig,
)
from repro.models.layers import COMPUTE_DTYPE as J_COMPUTE  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.core.optimizers.base import _leaves  # noqa: E402
from repro_torch.core.optimizers.presets import production_labels  # noqa: E402
from repro_torch.core.optimizers.schedule import linear_warmup_linear_decay  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    init_model,
    init_serve_cache,
    named_params,
    prefill_with_cache,
)
from repro_torch.models.gla import (  # noqa: E402
    gla_chunked,
    gla_decode_step,
    slstm_scan,
    SLSTMState,
)
from repro_torch.models.layers import COMPUTE_DTYPE  # noqa: E402
from repro_torch.models.model import cache_leaves, cache_map  # noqa: E402
from test_torch_recurrent import _close, _gla_inputs, _select, _t, BF16_ULP  # noqa: E402
from torch_ref import ref_params  # noqa: E402

torch.set_num_threads(1)

RECURRENT_ARCHS = ["xlstm-125m", "hymba-1.5b"]


# ---------------------------------------------------------------------------
# the optimizer alone, bit for bit
# ---------------------------------------------------------------------------


def _jax_leaves(state):
    out = []
    for leaf in jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, JQ)):
        out += [leaf.codes, *leaf.scales] if isinstance(leaf, JQ) else [leaf]
    return [np.asarray(x) for x in out]


def _torch_leaves(state):
    out = []
    for leaf in _leaves(state):
        out += [leaf.codes, *leaf.scales] if isinstance(leaf, QuantizedTensor) else [leaf]
    return [x.detach().cpu().numpy() for x in out]


def _bits(a):
    return a.view(np.uint32) if a.dtype == np.float32 else a


# small trees with the full-size routes (see the module docstring)
MINI = {
    "xlstm": JModelConfig(name="xlstm-mini", num_layers=2, d_model=256, num_heads=4,
                          num_kv_heads=4, head_dim=64, d_ff=0, vocab_size=512,
                          blocks=(JLayerSpec("mlstm", 0), JLayerSpec("slstm", 0)), remat=False),
    # head_dim = ssm_state and d_ff = 2 * d_model, so that the leaves share
    # few shapes (eager JAX compiles every op for every new shape)
    "hymba": JModelConfig(name="hymba-mini", num_layers=1, d_model=416, num_heads=13,
                          num_kv_heads=13, head_dim=16, d_ff=832, vocab_size=512, ssm_state=16,
                          blocks=(JLayerSpec("hymba", 0),), remat=False),
}
MINI_FUSED = {
    "xlstm": {"decoder/0/sub0/w_in", "decoder/0/sub0/w_out", "decoder/1/sub0/w_gates",
              "decoder/1/sub0/w_out", "decoder/1/sub0/mlp/w2"},
    "hymba": set(),
}


def _grads(jparams):
    """The seeded gradients of the three steps."""
    rng = np.random.default_rng(1)
    return [jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * 1e-2).astype(np.float32), jparams)
        for _ in range(3)]


def _reference_updates(mini):
    """The reference's params of ``MINI[mini]`` and its three eager updates:
    (params, grads, params and state after them)."""
    jparams = jax.tree_util.tree_map(np.asarray, ref_params(MINI[mini]))
    jopt = j_make("production4bit", j_sched(1e-3, 1, 10))
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    js = jopt.init(jp)
    grads = _grads(jparams)
    for step, g in enumerate(grads):
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                             key=jax.random.fold_in(jax.random.PRNGKey(3), step))
    return jparams, grads, jp, js


@pytest.fixture(scope="module")
def reference():
    """Both minis' reference updates, side by side: eager JAX compiles every
    op for every new shape, outside the GIL."""
    with ThreadPoolExecutor(len(MINI)) as pool:
        return dict(zip(MINI, pool.map(_reference_updates, MINI)))


@pytest.mark.parametrize("mini", list(MINI))
def test_production4bit_sr_updates_bit_equal(mini, reference):
    jparams, grads, jp, js = reference[mini]
    tparams = params_from_jax(jparams, device="cpu")
    topt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 1, 10))
    ts = topt.init(tparams)
    for step, g in enumerate(grads):
        tparams, ts = topt.update(params_from_jax(g, device="cpu"), ts, tparams,
                                  key=sr.fold_in(sr.PRNGKey(3), step))
    jl, tl = _jax_leaves(js), _torch_leaves(ts)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape, b.shape)
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"state leaf {i}")
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for k, p in tparams.items():
        np.testing.assert_allclose(p.numpy(), jflat[k].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    labels, jlab = production_labels(), j_labels()
    labs = {k: labels(k, p) for k, p in tparams.items()}
    assert labs == {k: jlab(k, None) for k in tparams}
    fused = {k for k, p in tparams.items() if labs[k] == "4bit" and p.ndim >= 2
             and p.shape[-1] % 256 == 0 and p.numel() > 4096}
    assert fused == MINI_FUSED[mini]
    four = ts.states["4bit"].states[0].inner
    if mini == "xlstm":
        rg = four.v["decoder/1/sub0/r_gates"]  # 5-D: one rank-1 stat per dim
        assert [tuple(s.shape) for s in rg.scales] == [(1,), (4,), (4,), (64,), (64,)]
        assert isinstance(four.m["decoder/0/sub0/wq"], QuantizedTensor)
    else:
        assert isinstance(four.m["decoder/0/sub0/ssm_dt"], QuantizedTensor)


# ---------------------------------------------------------------------------
# full size: labels, routes, structural bytes
# ---------------------------------------------------------------------------

FUSED = {
    "xlstm-125m": {f"decoder/0/sub{i}/{n}" for i in range(3) for n in ("w_in", "w_out")}
    | {f"decoder/0/sub3/{n}" for n in ("w_gates", "w_out", "mlp/w1", "mlp/w2", "mlp/w3")},
    "hymba-1.5b": set(),
}
# elements by route: (B1, unfused 4-bit, fp32-labeled)
ROUTE_ELEMENTS = {
    "xlstm-125m": (31_850_496, 17_750_016, 77_279_232),
    "hymba-1.5b": (0, 1_330_115_200, 102_507_200),
}


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_full_size_labels_and_fused_routes(arch):
    params = named_params(init_model(get_config(arch), device="meta"))
    labels, jlab = production_labels(), j_labels()
    labs = {k: labels(k, p) for k, p in params.items()}
    assert labs == {k: jlab(k, None) for k in params}
    fused = {k for k, p in params.items()
             if labs[k] == "4bit" and p.ndim >= 2 and p.shape[-1] % 256 == 0
             and p.numel() > 4096}
    assert fused == FUSED[arch]
    unfused = {k for k, p in params.items()
               if labs[k] == "4bit" and k not in fused and p.numel() > 4096}
    counts = tuple(sum(params[k].numel() for k in s) for s in (
        fused, unfused, {k for k in params if labs[k] == "fp32"}))
    assert counts == ROUTE_ELEMENTS[arch]
    state = make_optimizer("production4bit", 1e-3).init(params)
    m = state.states["4bit"].states[0].inner.m
    assert all(isinstance(m[k], QuantizedTensor) for k in fused | unfused)
    if arch == "hymba-1.5b":
        # properties of the reference: the output scales are 4-bit
        for name in ("scale_attn", "scale_ssm"):
            assert labs[f"decoder/1/sub0/{name}"] == "4bit"
        assert labs["decoder/1/sub0/norm1"] == "fp32"
        assert tuple(params["decoder/3/sub0/mlp/w1"].shape) == (15, 1600, 5504)


def test_gla_decode_step_continues_chunked():
    q, k, v, log_a, _ = _gla_inputs(24, 2, B=1, H=2)
    tq, tk, tv, tla = map(_t, (q, k, v, log_a))
    full, _ = gla_chunked(tq, tk, tv, tla, chunk=8)
    _, st = gla_chunked(tq[:, :16], tk[:, :16], tv[:, :16], tla[:, :16], chunk=8)
    _, jst = j_gla.gla_chunked(*(jnp.asarray(a[:, :16]) for a in (q, k, v, log_a)), chunk=8)
    ys, jys = [], []
    for t in range(16, 24):
        sl = slice(t, t + 1)
        y, st = gla_decode_step(tq[:, sl], tk[:, sl], tv[:, sl], tla[:, sl], st)
        jy, jst = j_gla.gla_decode_step(*(jnp.asarray(a[:, sl]) for a in (q, k, v, log_a)), jst)
        ys.append(y)
        jys.append(np.asarray(jy))
    got = torch.cat(ys, dim=1).numpy()
    _close(got, full[:, 16:].numpy(), what="decode vs chunked")
    _close(got, np.concatenate(jys, axis=1), what="decode vs reference")
    for a, b in zip(st, jst):
        _close(a.numpy(), b, what="state")


@pytest.mark.parametrize("masked", [False, True])
def test_slstm_scan_matches_reference(masked):
    B, S, H, dh = 3, 13, 4, 8
    D = H * dh
    rng = np.random.default_rng(3)
    gates = jnp.asarray(rng.normal(size=(B, S, 4, D)).astype(np.float32)).astype(J_COMPUTE)
    r = (rng.normal(size=(H, 4, dh, dh)) * 0.3).astype(np.float32)
    mask = np.arange(S)[None, :] < np.array([13, 7, 1])[:, None] if masked else None
    jh, jst = jax.jit(lambda g, rr, m: j_gla.slstm_scan(g, rr, H, step_mask=m))(
        gates, r, None if mask is None else jnp.asarray(mask))
    tg = torch.from_numpy(np.asarray(gates.astype(jnp.float32))).to(COMPUTE_DTYPE)
    th, tst = slstm_scan(tg, _t(r), H, step_mask=None if mask is None else torch.from_numpy(mask))
    assert th.dtype == COMPUTE_DTYPE and isinstance(tst, SLSTMState)
    # h is rounded to bf16 by both: compare in its units
    np.testing.assert_allclose(th.float().numpy(), np.asarray(jh.astype(jnp.float32)),
                               atol=BF16_ULP, rtol=0)
    for name, a, b in zip(SLSTMState._fields, tst, jst):
        _close(a.numpy(), b, what=name)
    if masked:
        # row 2 took one real step: its state is the state after step 0
        _, one = slstm_scan(tg[2:3, :1], _t(r), H)
        for a, b in zip(tst, one):
            assert torch.equal(a[2:3], b)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_prefill_matches_decode_oracle(arch):
    """Two right-padded prompts in one batched prefill (the padded steps of
    the short one are identity steps, or frozen in the sLSTM) against the
    token-at-a-time decode; then four greedy steps from both caches."""
    cfg = reduced_config(arch)
    jparams = ref_params(j_reduced(arch))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    prompts = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23], [9, 10]]
    B, S = len(prompts), max(len(p) for p in prompts)
    with torch.no_grad():
        oracle = init_serve_cache(cfg, B, 256, device="cpu")
        last = [None] * B
        for t in range(S):
            # a row whose prompt has ended stops here: its cache must hold
            # the prompt's state alone, as the batched prefill's does
            toks = torch.tensor([p[min(t, len(p) - 1)] for p in prompts])
            logits, stepped = decode_step(params, cfg, cache_map(torch.clone, oracle), toks,
                                          torch.full((B,), t))
            live = torch.tensor([t < len(p) for p in prompts])
            _select(oracle, stepped, live)
            for b, p in enumerate(prompts):
                if t == len(p) - 1:
                    last[b] = logits[b]
        l_oracle = torch.stack(last)
        toks = torch.zeros((B, S), dtype=torch.int64)
        for b, p in enumerate(prompts):
            toks[b, :len(p)] = torch.tensor(p)
        lens = torch.tensor([len(p) for p in prompts])
        batch = init_serve_cache(cfg, B, 256, device="cpu")
        l_batch, batch = prefill_with_cache(params, cfg, toks, lens, batch)
        # measured: equal (both archs)
        np.testing.assert_allclose(l_batch.numpy(), l_oracle.numpy(), atol=5e-2, rtol=0)
        # the caches themselves: positions equal, K/V and the recurrent
        # states of both rows (the short one's padded steps identities or
        # frozen) within 1e-3 of each leaf's scale (measured at most 3.0e-7)
        for a, o in zip(cache_leaves(batch), cache_leaves(oracle)):
            if a.dtype in (torch.int32, torch.int64):
                assert torch.equal(a, o)
                continue
            a, o = a.float(), o.float()
            finite = o > -1e29  # the sLSTM stabilizer starts at -1e30
            assert torch.equal(a > -1e29, finite)
            err = float((a - o)[finite].abs().max()) if finite.any() else 0.0
            assert err <= 1e-3 * max(float(o[finite].abs().max()), 1e-30), err
        pos = lens.clone()
        tok_a = torch.argmax(l_oracle, -1)
        tok_b = torch.argmax(l_batch, -1)
        for t in range(4):
            la, oracle = decode_step(params, cfg, oracle, tok_a, pos + t)
            lb, batch = decode_step(params, cfg, batch, tok_b, pos + t)
            np.testing.assert_allclose(lb.numpy(), la.numpy(), atol=5e-2, rtol=0)
            tok_a, tok_b = torch.argmax(la, -1), torch.argmax(lb, -1)


def test_recurrent_constants():
    """The sLSTM MLP width and the caches' shapes at full size."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import slstm_ff

    assert slstm_ff(768) == 1024 and slstm_ff(64) == 128
    x = get_config("xlstm-125m")
    c = init_serve_cache(x, 2, 512, device="meta")
    assert tuple(c[0]["sub0"].S.shape) == (3, 2, 4, 192, 192)
    assert tuple(c[0]["sub3"].m.shape) == (3, 2, 768)
    m = init_serve_cache(reduced_config("xlstm-125m"), 1, 64, device="cpu")[1]["sub0"].m
    assert torch.equal(m, torch.full_like(m, -1e30))
    h = get_config("hymba-1.5b")
    c = init_serve_cache(h, 2, 4096, device="meta")
    assert [tuple(u["sub0"]["attn"].k.shape[:3]) for u in c] == [
        (1, 2, 4096), (14, 2, 1024), (1, 2, 4096), (15, 2, 1024), (1, 2, 4096)]
    assert tuple(c[1]["sub0"]["ssm"].S.shape) == (14, 2, 25, 16, 64)
    assert math.isclose(h.d_model / h.num_heads, 64)


def test_reference_sums_bf16_cotangents_in_bf16():
    """A property of the reference, not a fault of the port: the cotangent of
    a bf16 weight broadcast over (B, S, dh), as hymba's ``ssm_D`` is in ``y +
    D * v``, is summed in bf16 by XLA and in fp32 by torch. At the reduced
    config's 2,048 terms a head the port lies within one bf16 rounding of
    the float64 sum of the same bf16 products, the reference off by more
    than 1e-2 on some head (measured 2.0e-3 and 9.5e-2)."""
    rng = np.random.default_rng(0)
    shape = (4, 32, 4, 16)
    v, w = (jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(J_COMPUTE)
            for _ in range(2))

    def f(d):
        y = d[None, None, :, None].astype(J_COMPUTE) * v
        return jnp.sum((y * w).astype(jnp.float32))

    jg = np.asarray(jax.jit(jax.grad(f))(jnp.ones(4, jnp.float32)), np.float64)
    tv, tw = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(COMPUTE_DTYPE)
              for a in (v, w))
    d = torch.ones(4, requires_grad=True)
    ((d[None, None, :, None].to(COMPUTE_DTYPE) * tv) * tw).float().sum().backward()
    exact = (tv * tw).double().sum(dim=(0, 1, 3)).numpy()  # the bf16 products
    port_err = np.max(np.abs(d.grad.numpy() - exact) / np.abs(exact))
    ref_err = np.max(np.abs(jg - exact) / np.abs(exact))
    print(f"relative error against the float64 sum: port {port_err:.3g}, reference {ref_err:.3g}")
    assert port_err <= 2.0 ** -8 and ref_err > 1e-2, (port_err, ref_err)

"""The port's recurrences and recurrent blocks (mLSTM, sLSTM, hymba) against
the JAX reference, on the CPU.

Inputs come from numpy with a seed; parameters are the reference's own
(initialised by JAX, carried across with ``convert``). Held to:

* ``gla_chunked`` in both ``normalize`` modes, with S a multiple of the
  chunk and not, from zeros and from an ``init_state``: output and final
  state within 1e-5 relative of the reference's scale (fp32 both sides; the
  chunk loop sums in another order than XLA's einsums: measured at most
  2.9e-7), and within the reference's own 2e-3 / 2e-4 of its float64
  ``naive_gla`` oracle (``tests/test_models.py``);
* ``gla_decode_step`` continuing a chunked prefix: within 1e-5 of the
  whole sequence chunked, and of the reference's decode steps;
* ``slstm_scan`` with and without ``step_mask`` (bf16 gate inputs, as the
  block gives them): h within one bf16 rounding (measured: equal) and the
  final state within 1e-5 relative of the reference's scale (measured at
  most 1.6e-7); a row's state after its last real step is exactly that of
  a scan that stops there;
* each block kind against the reference's ``apply_block`` (training
  regime, S = 20 with chunks of 16): output within four bf16 roundings of
  its scale (measured at most 0.57, hymba), gradients to x and to every
  leaf within 3e-2 relative L2 (``tests/test_torch_archs.py``'s bf16-level
  tolerance; measured at most 2.5e-2, hymba's ``ssm_D``, a sum over bf16
  products);
* the reference's ``xlstm`` and ``hymba`` ``DECODE_CASES``: the port's
  token-by-token decode against its own teacher-forced logits, the
  reference's teacher-forced logits and the reference's decode, within the
  reference's 0.02 (measured 0 within the port, 1.95e-3 against the
  reference); after it the caches' positions equal the reference's and
  their K/V and recurrent states lie within 2e-2 of their scale (measured
  at most 2.0e-3, one bf16 rounding of hymba's K; the states 2.2e-4);
* the reference's non-random leaves: ``init_model`` makes the same
  constants (norm scales, mLSTM's ``b_if``, hymba's ``ssm_dt_bias``,
  ``ssm_A_log``, ``ssm_D``, ``scale_attn``, ``scale_ssm``), and no other
  leaf is constant in either;
* per reduced arch: the cacheless ``prefill`` against the reference's,
  2e-2 (measured 2.1e-3 / 3.0e-3); a batched, right-padded ``prefill_with_cache`` of two prompts
  against a token-by-token decode oracle within the reference's 5e-2
  (``tests/test_serving.py::test_prefill_matches_decode_oracle_archs``),
  the caches' K/V, positions and recurrent states within 1e-3 of their
  scale, then four greedy decode steps from both caches.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_models import naive_gla  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import LayerSpec as JLayerSpec  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.models import init_serve_cache as j_init_serve_cache  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models import gla as j_gla  # noqa: E402
from repro.models.blocks import apply_block as j_apply_block  # noqa: E402
from repro.models.blocks import init_block as j_init_block  # noqa: E402
from repro.models.layers import COMPUTE_DTYPE as J_COMPUTE  # noqa: E402
from repro.models.model import forward_hidden as j_forward_hidden  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import load_params, params_from_jax  # noqa: E402
from repro_torch.models import (  # noqa: E402
    LayerSpec,
    ModelConfig,
    decode_step,
    forward_hidden,
    init_model,
    init_serve_cache,
    named_params,
    prefill,
    prefill_with_cache,
)
from repro_torch.models.blocks import RECURRENT  # noqa: E402
from repro_torch.models.gla import (  # noqa: E402
    GLAState,
    SLSTMState,
    gla_chunked,
    gla_decode_step,
    slstm_scan,
)
from repro_torch.models.layers import COMPUTE_DTYPE  # noqa: E402
from repro_torch.models.model import cache_leaves, cache_map  # noqa: E402

torch.set_num_threads(1)

RECURRENT_ARCHS = ["xlstm-125m", "hymba-1.5b"]
BF16_ULP = 2.0 ** -7
FP32_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, rtol=FP32_RTOL, what=""):
    """|got - want| within rtol of want's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= rtol, (what, err)
    return err


def _gla_inputs(S, seed, B=2, H=3, dk=8, dv=8):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, dk)).astype(np.float32)
    k = (rng.normal(size=(B, S, H, dk)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, S, H, dv)).astype(np.float32)
    log_a = (-np.abs(rng.normal(size=(B, S, H))) * 0.2).astype(np.float32)
    init = GLAState(*(rng.normal(size=s).astype(np.float32) * 0.5
                      for s in ((B, H, dk, dv), (B, H, dk))))
    return q, k, v, log_a, init


# ---------------------------------------------------------------------------
# gla_chunked, gla_decode_step, slstm_scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("S,chunk,init", [(37, 8, False), (64, 16, False), (21, 8, True)])
def test_gla_chunked_matches_reference(normalize, S, chunk, init):
    q, k, v, log_a, st = _gla_inputs(S, 1)
    jst = j_gla.GLAState(*(jnp.asarray(a) for a in st)) if init else None
    jy, jstate = jax.jit(lambda *a: j_gla.gla_chunked(*a, chunk=chunk, normalize=normalize,
                                                      init_state=jst))(q, k, v, log_a)
    ty, tstate = gla_chunked(_t(q), _t(k), _t(v), _t(log_a), chunk=chunk, normalize=normalize,
                             init_state=GLAState(*map(_t, st)) if init else None)
    assert ty.shape == (2, S, 3, 8) and ty.dtype == torch.float32
    _close(ty.numpy(), jy, what="y")
    for a, b in zip(tstate, jstate):
        _close(a.numpy(), b, what="state")
    if not init:
        np.testing.assert_allclose(ty.numpy(), naive_gla(q, k, v, log_a, normalize),
                                   rtol=2e-3, atol=2e-4)


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


# ---------------------------------------------------------------------------
# blocks against apply_block
# ---------------------------------------------------------------------------


def _nest(flat):
    tree = {}
    for path, t in flat.items():
        *dirs, leaf = path.split("/")
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = t
    return tree


BLOCK_CFG = dict(name="blocks", num_layers=1, d_model=64, num_heads=4, num_kv_heads=2,
                 head_dim=16, d_ff=256, vocab_size=128, ssm_state=8, gla_chunk=16)


@pytest.mark.parametrize("kind,window", [("mlstm", 0), ("slstm", 0), ("hymba", 8)])
def test_block_matches_reference(kind, window):
    jcfg = JModelConfig(blocks=(JLayerSpec(kind, window),), remat=False, **BLOCK_CFG)
    cfg = ModelConfig(blocks=(LayerSpec(kind, window),), **BLOCK_CFG)
    jp = jax.jit(lambda k: j_init_block(k, jcfg, kind)[0])(jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    B, S = 2, 20
    x = jnp.asarray(rng.normal(size=(B, S, 64)).astype(np.float32)).astype(J_COMPUTE)
    w = rng.normal(size=(B, S, 64)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))

    def jloss(p, xx):
        out, _, _ = j_apply_block(p, xx, JLayerSpec(kind, window), jcfg, positions=pos,
                                  cache=None, cur_pos=None)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(jp, x)
    flat = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for t in flat.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(COMPUTE_DTYPE).requires_grad_(True)
    tout, _ = RECURRENT[kind](_nest(flat), tx, LayerSpec(kind, window), cfg,
                          positions=torch.arange(S)[None].expand(B, S))
    (tout.float() * torch.from_numpy(w)).sum().backward()
    jout = np.asarray(jout.astype(jnp.float32))
    assert np.max(np.abs(tout.detach().float().numpy() - jout)) <= 4 * BF16_ULP * np.abs(jout).max()
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), device="cpu")
    assert list(flat) == list(jflat)
    for k, t in flat.items():
        ref = jflat[k].numpy()
        err = np.linalg.norm(t.grad.numpy() - ref) / max(np.linalg.norm(ref), 1e-12)
        assert err < 3e-2, (kind, k, err)
    ref = np.asarray(jgx.astype(jnp.float32))
    err = np.linalg.norm(tx.grad.float().numpy() - ref) / np.linalg.norm(ref)
    assert err < 3e-2, (kind, "x", err)


# ---------------------------------------------------------------------------
# decode parity: the reference's xlstm and hymba DECODE_CASES
# ---------------------------------------------------------------------------

DECODE_CASES = {
    "xlstm": dict(blocks=(("mlstm", 0), ("slstm", 0)), gla_chunk=8),
    "hymba": dict(blocks=(("hymba", 8),) * 2, ssm_state=4, gla_chunk=8),
}
CACHE_RTOL = 2e-2  # test_torch_recurrent_serve.py's bound on states


def _port_model(cfg, jparams):
    model = init_model(cfg, device="cpu")
    load_params(model, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                       device="cpu"))
    return model


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_teacher_forced(case):
    kw = dict(DECODE_CASES[case])
    specs = kw.pop("blocks")
    common = dict(name=case, num_layers=len(specs), d_model=32, num_heads=4, num_kv_heads=2,
                  head_dim=8, d_ff=64, vocab_size=128, **kw)
    jcfg = JModelConfig(blocks=tuple(JLayerSpec(*s) for s in specs), remat=False, **common)
    cfg = ModelConfig(blocks=tuple(LayerSpec(*s) for s in specs), **common)
    jparams = jax.jit(lambda k: j_init(k, jcfg)[0])(jax.random.PRNGKey(0))
    model = _port_model(cfg, jparams)
    B, S = 2, 12
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, 128))
    with torch.no_grad():
        x = forward_hidden(model, {"tokens": torch.from_numpy(tokens).long()})
        full = torch.einsum("bsd,dv->bsv", x.to(COMPUTE_DTYPE),
                            model.head.to(COMPUTE_DTYPE)).float().numpy()
        params = {k: p.detach() for k, p in named_params(model).items()}
        caches = init_serve_cache(cfg, B, 256, device="cpu")
        dec = []
        for t in range(S):
            logits, caches = decode_step(params, cfg, caches, torch.from_numpy(tokens[:, t]).long(),
                                         torch.full((B,), t, dtype=torch.int64))
            dec.append(logits.numpy())
    dec = np.stack(dec, axis=1)

    def j_full(p, t):
        xx, _ = j_forward_hidden(p, jcfg, {"tokens": t})
        return jnp.einsum("bsd,dv->bsv", xx.astype(J_COMPUTE),
                          p["head"].astype(J_COMPUTE)).astype(jnp.float32)

    jfull = np.asarray(jax.jit(j_full)(jparams, jnp.asarray(tokens)))
    j_decode = jax.jit(lambda p, c, tok, pos: j_decode_step(p, jcfg, c, tok, pos))
    jc = j_init_serve_cache(jcfg, B, 256)
    jdec = []
    for t in range(S):
        jl, jc = j_decode(jparams, jc, jnp.asarray(tokens[:, t]), jnp.full((B,), t, jnp.int32))
        jdec.append(np.asarray(jl))
    jdec = np.stack(jdec, axis=1)
    for what, a, b in (("decode vs teacher-forced", dec, full),
                       ("teacher-forced vs reference", full, jfull),
                       ("decode vs reference decode", dec, jdec)):
        assert np.max(np.abs(a - b)) < 0.02, (case, what, np.max(np.abs(a - b)))
    # the caches hold the reference's: positions equal, K/V and recurrent
    # states within CACHE_RTOL of their scale
    for tu, ju in zip(caches, jc):
        for sub in tu:
            tl = jax.tree_util.tree_leaves(ju[sub])
            mine = cache_leaves(tu[sub])
            assert len(mine) == len(tl)
            for a, b in zip(mine, tl):
                assert tuple(a.shape) == tuple(b.shape), (sub, a.shape, b.shape)
                a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
                scale = max(float(np.abs(b).max()), 1.0)
                err = float(np.abs(a - b).max())
                assert err <= CACHE_RTOL * scale, (case, sub, a.shape, err, scale)


# ---------------------------------------------------------------------------
# init constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_init_constants_match_reference(arch):
    """Leaves equal under two seeds are the constants: the same set in both
    packages, with the same values."""
    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    init = jax.jit(lambda k: j_init(k, jcfg)[0])
    ja, jb = (params_from_jax(jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(s))),
                              device="cpu") for s in (0, 1))
    ta, tb = (named_params(init_model(cfg, seed=s, device="cpu")) for s in (0, 1))
    j_const = {k for k in ja if torch.equal(ja[k], jb[k])}
    t_const = {k for k in ta if torch.equal(ta[k], tb[k])}
    assert t_const == j_const
    for k in j_const:
        assert torch.equal(ta[k].detach(), ja[k]), k
    names = {k.rsplit("/", 1)[-1] for k in j_const}
    assert names >= ({"b_if", "norm"} if arch == "xlstm-125m" else
                     {"ssm_dt_bias", "ssm_A_log", "ssm_D", "scale_attn", "scale_ssm"}), names


# ---------------------------------------------------------------------------
# per reduced arch: cacheless prefill; batched prefill against the decode oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_prefill_matches_reference(arch):
    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    jparams = jax.jit(lambda k: j_init(k, jcfg)[0])(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(6).integers(0, 512, size=(2, 19)).astype(np.int32)
    jl = np.asarray(jax.jit(lambda p, t: j_prefill(p, jcfg, {"tokens": t}))(jparams, toks))
    with torch.no_grad():
        tl = prefill(params, cfg, {"tokens": torch.from_numpy(toks).long()}).numpy()
    assert np.max(np.abs(tl - jl)) < 2e-2, np.max(np.abs(tl - jl))


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_prefill_matches_decode_oracle(arch):
    """Two right-padded prompts in one batched prefill (the padded steps of
    the short one are identity steps, or frozen in the sLSTM) against the
    token-at-a-time decode; then four greedy steps from both caches."""
    cfg = reduced_config(arch)
    jparams = jax.jit(lambda k: j_init(k, j_reduced(arch))[0])(jax.random.PRNGKey(0))
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


def _select(dst, src, live):
    """dst <- src in the rows (batch axis 1 of every stacked leaf) of live."""
    for a, b in zip(cache_leaves(dst), cache_leaves(src)):
        a[:, live] = b[:, live]


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

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

``gla_chunked`` is held in ``tests/test_torch_recurrent_train.py``;
``gla_decode_step``, ``slstm_scan``, the constants, the bf16 cotangents and
the padded prefill against its decode oracle in
``tests/test_torch_recurrent_optim.py`` (pytest-xdist's ``--dist
loadfile`` hands out the files with the most tests first).
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import LayerSpec as JLayerSpec  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.models import init_serve_cache as j_init_serve_cache  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
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
)
from repro_torch.models.blocks import RECURRENT  # noqa: E402
from repro_torch.models.gla import GLAState  # noqa: E402
from repro_torch.models.layers import COMPUTE_DTYPE  # noqa: E402
from repro_torch.models.model import cache_leaves  # noqa: E402
from torch_ref import ref_params  # noqa: E402

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
    jparams = ref_params(jcfg)
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
    jparams = ref_params(jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(6).integers(0, 512, size=(2, 19)).astype(np.int32)
    jl = np.asarray(jax.jit(lambda p, t: j_prefill(p, jcfg, {"tokens": t}))(jparams, toks))
    with torch.no_grad():
        tl = prefill(params, cfg, {"tokens": torch.from_numpy(toks).long()}).numpy()
    assert np.max(np.abs(tl - jl)) < 2e-2, np.max(np.abs(tl - jl))


def _select(dst, src, live):
    """dst <- src in the rows (batch axis 1 of every stacked leaf) of live."""
    for a, b in zip(cache_leaves(dst), cache_leaves(src)):
        a[:, live] = b[:, live]

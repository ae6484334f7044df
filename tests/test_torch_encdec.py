"""The port's encoder-decoder (whisper-large-v3: LayerNorm, sinusoidal
positions, non-causal encoder attention, the decoder's cross-attention)
against the JAX reference, on the CPU.

Inputs come from numpy with a seed; parameters are the reference's own
(initialised by JAX, carried across with ``convert``). Held to:

* ``layernorm``: fp32 within 1e-6 relative of the reference's scale, bf16
  output within one bf16 rounding;
* ``sinusoidal_positions`` / ``sinusoidal_at``: within fp32 rounding, one
  fp32 ulp of the largest angle (1.2e-4 at 1500 positions; measured 3.1e-5).
  Both divide by ``power(10000, 2i/D)``, and ``jnp.power`` is not
  correctly rounded: 11 of the 640 divisors at D = 1280 differ in their
  last bit;
* ``train_attention`` without the causal mask, 1 and 37 queries over 1500
  keys (past the reference's k-chunk of 1024, so the reference runs two
  chunks of online softmax and the port one softmax): within 1e-5 of the
  reference's scale (fp32 rounding);
* ``init_model``: the same constant leaves as the reference's (LayerNorm
  scales ones and biases zeros, chosen by path), no other leaf constant;
* the reduced config: loss within 2e-3 relative and every gradient leaf
  within 3e-2 relative L2 (the earlier slices' bf16-level bounds), the
  reference's leaf order; the cacheless ``prefill`` over frames and tokens
  within 2e-2;
* the reference's ``test_encdec_decode_parity`` (its 2-layer config) and the
  reduced config: the encoder once (``encode``), then a token-by-token
  ``decode_step(enc_out=)``, against the port's and the reference's
  teacher-forced logits and the reference's decode, within the reference's
  0.02; the decoder blocks' caches are ``{"self": KVCache, "cross": None}``
  with the reference's positions.
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
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models.attention import train_attention as j_train_attention  # noqa: E402
from repro.models.layers import COMPUTE_DTYPE as J_COMPUTE  # noqa: E402
from repro.models.layers import layernorm as j_layernorm  # noqa: E402
from repro.models.layers import sinusoidal_at as j_sinusoidal_at  # noqa: E402
from repro.models.layers import sinusoidal_positions as j_sinusoidal_positions  # noqa: E402
from repro.models.model import _final_norm as j_final_norm  # noqa: E402
from repro.models.model import _run_units as j_run_units  # noqa: E402
from repro.models.model import forward_hidden as j_forward_hidden  # noqa: E402
from repro.models.model import plan_scan_units as j_plan  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import load_params, params_from_jax  # noqa: E402
from repro_torch.models import (  # noqa: E402
    LayerSpec,
    ModelConfig,
    decode_step,
    encode,
    forward_hidden,
    init_model,
    init_serve_cache,
    loss_fn,
    named_params,
    prefill,
)
from repro_torch.models.attention import KVCache, train_attention  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    COMPUTE_DTYPE,
    layernorm,
    sinusoidal_at,
    sinusoidal_positions,
)
from torch_ref import ref_params  # noqa: E402

torch.set_num_threads(1)

WHISPER = "whisper-large-v3"
BF16_ULP = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def bf16_round(a):
    """numpy fp32 values that bf16 holds exactly (both models cast inputs to bf16)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def encdec_batch(cfg, seed, B=2, S=12, Se=20):
    """numpy inputs of an encoder-decoder: frames (B, Se, D), tokens and labels (B, S)."""
    rng = np.random.default_rng(seed)
    return {"frames": bf16_round(rng.normal(size=(B, Se, cfg.d_model))),
            "tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in b.items()}


def _port_model(cfg, jparams):
    model = init_model(cfg, device="cpu")
    load_params(model, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                       device="cpu"))
    return model


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 96)) * 3 + 1.5).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.normal(size=96)).astype(np.float32),
         "bias": (0.1 * rng.normal(size=96)).astype(np.float32)}
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    want = np.asarray(jax.jit(j_layernorm)(jx, p).astype(jnp.float32))
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = layernorm(tx, {k: _t(v) for k, v in p.items()})
    assert got.dtype == COMPUTE_DTYPE
    # bf16 output both ways: one bf16 rounding of the value apart at most
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP, atol=1e-6)


def test_sinusoids_match_reference():
    for S, D in ((1500, 1280), (448, 1280), (20, 64)):
        want = np.asarray(jax.jit(lambda: j_sinusoidal_positions(S, D))())
        got = sinusoidal_positions(S, D).numpy()
        assert got.shape == (S, D) and got.dtype == np.float32
        # an angle's fp32 rounding (its ulp) through sin / cos
        assert np.max(np.abs(got - want)) <= np.spacing(np.float32(S)), (S, D)
    pos = np.array([0, 1, 7, 447, 1499], np.int32)
    want = np.asarray(jax.jit(lambda p: j_sinusoidal_at(p, 1280))(pos))
    got = sinusoidal_at(torch.from_numpy(pos).long(), 1280).numpy()
    assert np.max(np.abs(got - want)) <= np.spacing(np.float32(1499))
    # each row equals its row of the table (the decode step's and the
    # forward's sinusoids are the same numbers)
    assert torch.equal(sinusoidal_at(torch.arange(20), 64), sinusoidal_positions(20, 64))


@pytest.mark.parametrize("Sq", [1, 37])
def test_noncausal_attention_past_one_k_chunk(Sq):
    """Cross-attention's shape: Sq queries over 1500 keys, no mask; the
    reference takes two k-chunks of 1024 (online softmax), the port one."""
    rng = np.random.default_rng(Sq)
    B, Sk, H, D = 2, 1500, 2, 8
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, H, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, H, D)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: j_train_attention(a, b, c, causal=False))(q, k, v))
    got = train_attention(_t(q), _t(k), _t(v), causal=False).numpy()
    assert got.shape == (B, Sq, H, D)
    assert _rel(got, want) <= 1e-5, _rel(got, want)


# ---------------------------------------------------------------------------
# init constants; loss and gradients; cacheless prefill
# ---------------------------------------------------------------------------


def test_init_constants_match_reference():
    """Leaves equal under two seeds are the constants: the same set in both
    packages (every LayerNorm's scale and bias, found by path), the same
    values (ones and zeros)."""
    jcfg, cfg = j_reduced(WHISPER), reduced_config(WHISPER)
    init = jax.jit(lambda k: j_init(k, jcfg)[0])
    ja, jb = (params_from_jax(jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(s))),
                              device="cpu") for s in (0, 1))
    ta, tb = (named_params(init_model(cfg, seed=s, device="cpu")) for s in (0, 1))
    assert list(ta) == list(ja)  # the reference's leaf order
    j_const = {k for k in ja if torch.equal(ja[k], jb[k])}
    t_const = {k for k in ta if torch.equal(ta[k], tb[k])}
    assert t_const == j_const
    for k in j_const:
        assert torch.equal(ta[k].detach(), ja[k]), k
    assert {k.rsplit("/", 1)[-1] for k in j_const} == {"scale", "bias"}
    assert {"enc_norm/bias", "final_norm/scale", "decoder/0/sub0/norm3/bias",
            "encoder/0/sub0/norm1/scale"} <= j_const
    assert float(ta["final_norm/bias"].detach().abs().max()) == 0.0


def test_loss_and_grads_match_reference():
    jcfg, cfg = j_reduced(WHISPER), reduced_config(WHISPER)
    jparams = ref_params(jcfg)
    model = _port_model(cfg, jparams)
    b = encdec_batch(cfg, 1, B=2, S=16, Se=24)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(p, jcfg, b), has_aux=True))(
        jparams)
    tl, _ = loss_fn(model, _torch_batch(b))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), device="cpu")
    mine = named_params(model)
    assert list(mine) == list(jflat)
    for k, p in mine.items():
        ref = jflat[k].numpy()
        err = np.linalg.norm(p.grad.numpy() - ref) / max(np.linalg.norm(ref), 1e-12)
        assert err < 3e-2, (k, err)
    # the cacheless prefill over the same inputs
    b.pop("labels")
    jl = np.asarray(jax.jit(lambda p, bb: j_prefill(p, jcfg, bb))(jparams, b))
    with torch.no_grad():
        tl = prefill({k: p.detach() for k, p in mine.items()}, cfg, _torch_batch(b)).numpy()
    assert np.max(np.abs(tl - jl)) < 2e-2, np.max(np.abs(tl - jl))


# ---------------------------------------------------------------------------
# decode against the teacher-forced logits
# ---------------------------------------------------------------------------

TINY = dict(name="whisper_tiny", num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
            head_dim=8, d_ff=64, vocab_size=128, family="encdec", norm_type="layernorm",
            rope_variant="none", gated_mlp=False, tie_embeddings=True)


def _configs(case):
    if case == "reduced":
        return j_reduced(WHISPER), reduced_config(WHISPER)
    jcfg = JModelConfig(blocks=(JLayerSpec("dec", 0),) * 2, encoder_blocks=(JLayerSpec("enc", 0),) * 2,
                        remat=False, **TINY)
    cfg = ModelConfig(blocks=(LayerSpec("dec", 0),) * 2, encoder_blocks=(LayerSpec("enc", 0),) * 2,
                      **TINY)
    return jcfg, cfg


@pytest.mark.parametrize("case", ["test_models", "reduced"])
def test_decode_matches_teacher_forced(case):
    jcfg, cfg = _configs(case)
    jparams = ref_params(jcfg)
    model = _port_model(cfg, jparams)
    B, S, Se = 2, 10, 16
    b = encdec_batch(cfg, 3, B=B, S=S, Se=Se)
    b.pop("labels")
    tokens = b["tokens"]
    with torch.no_grad():
        x = forward_hidden(model, _torch_batch(b))
        full = torch.einsum("bsd,dv->bsv", x, model.embed.t().to(COMPUTE_DTYPE)).float().numpy()
        params = {k: p.detach() for k, p in named_params(model).items()}
        enc_out = encode(params, cfg, torch.from_numpy(b["frames"]))
        caches = init_serve_cache(cfg, B, 256, device="cpu")
        assert all(set(c) == {"sub0"} and c["sub0"]["cross"] is None
                   and isinstance(c["sub0"]["self"], KVCache) for c in caches)
        dec = []
        for t in range(S):
            logits, caches = decode_step(params, cfg, caches, torch.from_numpy(tokens[:, t]).long(),
                                         torch.full((B,), t, dtype=torch.int64), enc_out=enc_out)
            dec.append(logits.numpy())
    dec = np.stack(dec, axis=1)

    def j_full(p, bb):
        xx, _ = j_forward_hidden(p, jcfg, bb)
        return jnp.einsum("bsd,dv->bsv", xx.astype(J_COMPUTE),
                          p["embed"].T.astype(J_COMPUTE)).astype(jnp.float32)

    def j_encode(p, frames):
        e = frames.astype(J_COMPUTE) + j_sinusoidal_positions(Se, jcfg.d_model)[None].astype(
            J_COMPUTE)
        e, _, _ = j_run_units(jcfg, j_plan(jcfg.encoder_blocks), p["encoder"], e, positions=None)
        return j_final_norm(jcfg, e, p["enc_norm"])

    jfull = np.asarray(jax.jit(j_full)(jparams, b))
    j_enc = jax.jit(j_encode)(jparams, b["frames"])
    np.testing.assert_allclose(enc_out.float().numpy(), np.asarray(j_enc.astype(jnp.float32)),
                               atol=4 * BF16_ULP * float(jnp.abs(j_enc.astype(jnp.float32)).max()))
    j_dec = jax.jit(lambda p, c, tok, pos, e: j_decode_step(p, jcfg, c, tok, pos, enc_out=e))
    jc = j_init_serve_cache(jcfg, B, 256)
    jdec = []
    for t in range(S):
        jl, jc = j_dec(jparams, jc, jnp.asarray(tokens[:, t]), jnp.full((B,), t, jnp.int32), j_enc)
        jdec.append(np.asarray(jl))
    jdec = np.stack(jdec, axis=1)
    for what, a, c in (("decode vs teacher-forced", dec, full),
                       ("teacher-forced vs reference", full, jfull),
                       ("decode vs reference decode", dec, jdec)):
        assert np.max(np.abs(a - c)) < 0.02, (case, what, np.max(np.abs(a - c)))
    for tu, ju in zip(caches, jc):
        assert ju["sub0"]["cross"] is None
        np.testing.assert_array_equal(tu["sub0"]["self"].pos.numpy(),
                                      np.asarray(ju["sub0"]["self"].pos))


def test_full_size_shapes():
    """whisper-large-v3 on the meta device: 32 encoder and 32 decoder layers
    in one scan unit each, the reference's leaf names, 1,534,809,600
    parameters (encoder 629,309,440, decoder 839,106,560, embed 66,388,480)."""
    from repro_torch.configs import get_config

    cfg = get_config(WHISPER)
    params = named_params(init_model(cfg, device="meta"))
    count = lambda pre: sum(p.numel() for k, p in params.items() if k.startswith(pre))
    assert (count(""), count("encoder/"), count("decoder/"), count("embed")) == (
        1_534_809_600, 629_309_440, 839_106_560, 66_388_480)
    assert "head" not in params and tuple(params["enc_norm/scale"].shape) == (1280,)
    assert tuple(params["decoder/0/sub0/cross/wo"].shape) == (32, 20, 64, 1280)
    assert tuple(params["encoder/0/sub0/norm2/bias"].shape) == (32, 1280)
    assert "decoder/0/sub0/mlp/w3" not in params
    c = init_serve_cache(cfg, 4, 448, device="meta")
    assert tuple(c[0]["sub0"]["self"].k.shape) == (32, 4, 512, 20, 64)

"""The port's serving path against the JAX reference, on the CPU.

The ``TINY`` config of ``tests/test_serving.py`` with the reference's own
parameters carried across (``convert``). Held to:

* KV cache writes (``cache_prefill``, ``cache_update``): equal, with prompts
  shorter and longer than the cache;
* ``decode_attention``: within 1e-5 (fp32 both sides);
* ``prefill_with_cache`` and teacher-forced ``decode_step`` logits: within
  2e-2 absolute (both compute in bf16 but round their products at other
  places; measured 2.5e-3 at prefill, at most 3.9e-3 over four decode
  steps), the bound the reference holds its own batched prefill to against
  its token-at-a-time oracle;
* sampling key words and uniforms: bit-equal; sampled tokens equal on the
  same logits;
* q4 ``prepare_params``: codes and scales bit-equal leaf by leaf, and
  ``materialize`` equal, on leaves with a kernel view and on leaves
  without one (odd last dims); ``weight_report`` totals equal, including
  the structural internlm2-1.8b counts;
* the engine: its q4 streams against the reference engine's (greedy and
  sampled, same seed and request ids): the first 8 tokens of every stream
  equal and at least 90% of all tokens (measured 119 of 120: one sampled
  stream parts at its last token, where the two frameworks' bf16 rounding
  flips a near tie); streams reproducible and slot-invariant, no KV leak
  across retire and backfill, early EOS, and the CLI at CPU scale.

Retire and backfill, early EOS and the CLI are in
``tests/test_torch_recurrent_serve.py`` (pytest-xdist's ``--dist
loadfile`` hands out the files with the most tests first).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels import sr as j_sr  # noqa: E402
from repro.models import LayerSpec as JLayerSpec  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import init_serve_cache as j_init_serve_cache  # noqa: E402
from repro.models import prefill_with_cache as j_prefill_with_cache  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import materialize as j_materialize  # noqa: E402
from repro.serve import prepare_params as j_prepare_params  # noqa: E402
from repro.serve import request_key_words as j_request_key_words  # noqa: E402
from repro.serve import sample_tokens as j_sample_tokens  # noqa: E402
from repro.serve import weight_report as j_weight_report  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, serving_params_from_jax  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor, dequantize, quantize  # noqa: E402
from repro_torch.kernels import quant4  # noqa: E402
from repro_torch.models import LayerSpec, ModelConfig, init_model, named_params  # noqa: E402
from repro_torch.models import decode_step, init_serve_cache, prefill_with_cache  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Request,
    ServeEngine,
    materialize,
    prepare_params,
    request_key_words,
    sample_tokens,
    weight_report,
)
from repro_torch.serve.sampling import sample_uniforms  # noqa: E402
from repro_torch.serve.weights import WEIGHT_Q4, kernel_view  # noqa: E402

torch.set_num_threads(1)

J_TINY = JModelConfig(
    name="serve-test", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=256, blocks=(JLayerSpec("dense", 0),) * 2, remat=False,
)
TINY = ModelConfig(
    name="serve-test", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=256, blocks=(LayerSpec("dense", 0),) * 2,
)
LOGIT_ATOL = 2e-2
PROMPTS = [[5, 6, 7, 8, 9], [10, 11, 12], [13]]


@pytest.fixture(scope="module")
def tiny():
    jparams = jax.jit(lambda k: j_init_model(k, J_TINY)[0])(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _padded(prompts):
    S = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), S), np.int32)
    for b, p in enumerate(prompts):
        toks[b, : len(p)] = p
    return toks, np.array([len(p) for p in prompts], np.int32)


# ---------------------------------------------------------------------------
# KV cache and decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s_max", [4, 16])
def test_cache_prefill_and_update_match_reference(s_max):
    # s_max 4: prompts longer than the cache keep their trailing positions
    B, S, H, D = 3, 10, 2, 8
    rng = np.random.default_rng(s_max)
    k_new = rng.normal(size=(B, S, H, D)).astype(np.float32)
    v_new = rng.normal(size=(B, S, H, D)).astype(np.float32)
    lengths = np.array([10, 3, 1], np.int32)
    j = j_attn.cache_prefill(j_attn.make_cache(B, s_max, H, D), jnp.asarray(k_new),
                             jnp.asarray(v_new), jnp.asarray(lengths))
    t = attn.cache_prefill(attn.make_cache(B, s_max, H, D, device="cpu"), torch.from_numpy(k_new),
                           torch.from_numpy(v_new), torch.from_numpy(lengths))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_np(a), _np(b))
    # one decode write at each row's next position
    pos = lengths.copy()
    k1 = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    v1 = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    j = j_attn.cache_update(j, jnp.asarray(k1), jnp.asarray(v1), jnp.asarray(pos))
    t = attn.cache_update(t, torch.from_numpy(k1), torch.from_numpy(v1), torch.from_numpy(pos))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_decode_attention_matches_reference():
    B, Smax, Hkv, G, D = 3, 64, 2, 2, 16
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, 1, Hkv * G, D)).astype(np.float32)
    k = rng.normal(size=(B, Smax, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Smax, Hkv, D)).astype(np.float32)
    pos = np.full((B, Smax), -1, np.int32)
    pos[0, :40] = np.arange(40)
    pos[1, :] = np.arange(64, 128)       # a wrapped circular cache
    pos[2, :5] = np.arange(5)
    cur = np.array([39, 127, 3], np.int32)  # row 2 must ignore position 4
    for window in (0, 16):
        j = j_attn.decode_attention(jnp.asarray(q), j_attn.KVCache(*map(jnp.asarray, (k, v, pos))),
                                    jnp.asarray(cur), window=window, k_chunk=16)
        t = attn.decode_attention(torch.from_numpy(q),
                                  attn.KVCache(*map(torch.from_numpy, (k, v, pos))),
                                  torch.from_numpy(cur), window=window, k_chunk=16)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# prefill + decode logits
# ---------------------------------------------------------------------------


def test_prefill_and_decode_logits_match_reference(tiny):
    jparams, tparams = tiny
    toks, lens = _padded(PROMPTS)
    j_prefill = jax.jit(lambda p, t, n, c: j_prefill_with_cache(p, J_TINY, t, n, c))
    j_decode = jax.jit(lambda p, c, t, n: j_decode_step(p, J_TINY, c, t, n))
    jl, jc = j_prefill(jparams, jnp.asarray(toks), jnp.asarray(lens),
                       j_init_serve_cache(J_TINY, len(PROMPTS), 64))
    tl, tc = prefill_with_cache(tparams, TINY, torch.from_numpy(toks).long(),
                                torch.from_numpy(lens), init_serve_cache(TINY, 3, 64, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(tc[0]["sub0"].pos.numpy(), np.asarray(jc[0]["sub0"].pos))
    # teacher-forced decode: both sides are fed the reference's greedy tokens
    pos = lens.copy()
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for t in range(4):
        jl, jc = j_decode(jparams, jc, jnp.asarray(tok), jnp.asarray(pos + t))
        tl, tc = decode_step(tparams, TINY, tc, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos + t))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _key_words(rids):
    """(reference's vectorised words, the port's per-request words), (B, 2)."""
    jw = j_request_key_words(0, np.asarray(rids))
    tw = [request_key_words(0, r) for r in rids]
    return np.stack([np.asarray(w, np.int64) for w in jw], -1), np.array(tw, np.int64)


def test_request_key_words_and_uniforms_bit_equal():
    rids = [0, 1, 7, 12345, 2**31 + 5]
    jkw, tkw = _key_words(rids)
    np.testing.assert_array_equal(tkw, jkw)
    assert request_key_words(3, 7) == tuple(int(w) for w in j_request_key_words(3, 7))
    gen = np.array([0, 1, 5, 63, 1000], np.int64)
    V = 300
    k = jnp.asarray(jkw.astype(np.uint32))
    tk0, tk1 = j_sr.threefry2x32(k[:, 0], k[:, 1], jnp.asarray(gen, jnp.uint32),
                                 jnp.uint32(j_sr.STREAM_SAMPLE))
    bits, _ = j_sr.threefry2x32(tk0[:, None], tk1[:, None],
                                jnp.arange(V, dtype=jnp.uint32)[None, :], jnp.uint32(0))
    ju = np.asarray(j_sr.uniform_from_bits(bits))
    tu = sample_uniforms(torch.from_numpy(tkw), torch.from_numpy(gen), V).numpy()
    np.testing.assert_array_equal(tu, ju)


def test_sample_tokens_match_reference():
    B, V = 8, 64
    logits = (np.random.default_rng(1).normal(size=(B, V)) * 3.0).astype(np.float32)
    jkw, tkw = _key_words(list(range(B)))
    temp = np.array([0.0, 0.8, 0.8, 1.5, 0.8, 0.0, 0.5, 2.0], np.float32)
    top_k = np.array([0, 0, 1, 2, 40, 8, 16, 4], np.int32)
    j_sample = jax.jit(j_sample_tokens)
    for gen in range(16):
        g = np.full((B,), gen, np.int64)
        j = j_sample(jnp.asarray(logits), jnp.asarray(jkw.astype(np.uint32)),
                            jnp.asarray(g, jnp.uint32), jnp.asarray(temp), jnp.asarray(top_k))
        t = sample_tokens(torch.from_numpy(logits), torch.from_numpy(tkw), torch.from_numpy(g),
                          torch.from_numpy(temp), torch.from_numpy(top_k).long())
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# serving weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["q4", "bf16"])
def test_prepare_params_match_reference(tiny, mode):
    jparams, tparams = tiny
    jtree = jax.jit(lambda p: j_prepare_params(p, mode))(jparams)
    jflat = serving_params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), device="cpu")
    before = dict(quant4.LAUNCHES)
    mine = prepare_params(tparams, mode)
    assert list(mine) == list(jflat)
    n_quantized = 0
    for path, ours in mine.items():
        theirs = jflat[path]
        if isinstance(theirs, QuantizedTensor):
            n_quantized += 1
            assert isinstance(ours, QuantizedTensor) and ours.shape == theirs.shape, path
            assert ours.config == theirs.config, path
            assert torch.equal(ours.codes, theirs.codes), path
            assert len(ours.scales) == 1 and torch.equal(ours.scales[0], theirs.scales[0]), path
            assert torch.equal(dequantize(ours), dequantize(theirs)), path
        else:
            assert ours.dtype == theirs.dtype and torch.equal(ours, theirs), path
    assert n_quantized == (7 if mode == "q4" else 0)  # wk, wv: 4096 elements, not above
    jmat = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.jit(j_materialize)(jtree)),
                           device="cpu")
    for path, x in materialize(mine).items():
        assert torch.equal(x.float(), jmat[path]), path
    assert quant4.LAUNCHES == before  # the CPU takes the plain versions


def test_weight_report_matches_reference(tiny):
    jparams, tparams = tiny
    for mode in ("q4", "bf16"):
        j, t = j_weight_report(jparams, mode), weight_report(tparams, mode)
        for key in ("total_serve_bytes", "total_bf16_bytes", "quantized_leaves", "n_leaves",
                    "ratio_vs_bf16", "format"):
            assert t[key] == j[key], (mode, key)
        assert [(r["path"], r["serve_bytes"]) for r in t["leaves"]] == \
            [(r["path"], r["serve_bytes"]) for r in j["leaves"]]
    # the structural internlm2-1.8b counts (shapes only: meta / abstract)
    big = {k: p for k, p in named_params(init_model(get_config("internlm2-1.8b"),
                                                    device="meta")).items()}
    jbig = jax.eval_shape(lambda k: j_init_model(k, j_get_config("internlm2-1.8b"))[0],
                          jax.random.PRNGKey(0))
    q4, bf16 = weight_report(big, "q4"), weight_report(big, "bf16")
    assert q4["total_serve_bytes"] == j_weight_report(jbig, "q4")["total_serve_bytes"] \
        == 1_003_596_800
    assert bf16["total_serve_bytes"] == j_weight_report(jbig, "bf16")["total_serve_bytes"] \
        == 3_778_224_128
    assert q4["quantized_leaves"] == 11


def test_q4_leaf_the_kernel_cannot_take_raises():
    """``kernel_view`` refuses a leaf with no (R, C) view, naming its shape;
    ``prepare_params`` sends such a leaf through the plain quantizer."""
    with pytest.raises(ValueError, match=r"\(65, 127\)"):
        kernel_view((65, 127))
    x = torch.randn(65, 127, generator=torch.Generator().manual_seed(0))
    before = dict(quant4.LAUNCHES)
    q = prepare_params({"w": x}, "q4")["w"]
    want = quantize(x, WEIGHT_Q4)
    assert torch.equal(q.codes, want.codes) and torch.equal(q.scales[0], want.scales[0])
    assert torch.equal(materialize({"w": q})["w"], dequantize(want))
    assert quant4.LAUNCHES == before


@pytest.mark.parametrize("shape,codes,scales", [
    ((64, 257), (64, 129), (129,)),
    ((3, 50, 77), (3, 50, 39), (91,)),
], ids=["odd_last_dim", "odd_3d"])
def test_q4_odd_leaves_match_reference(shape, codes, scales):
    """Leaves without a kernel view (odd last dim: a zero pad nibble per code
    row, a short last scale block) against the reference's prepare_params
    and materialize: codes, scales and values bit-equal, bytes equal."""
    x = (np.random.default_rng(3).normal(size=shape) * 0.02).astype(np.float32)
    jq = j_prepare_params({"w": jnp.asarray(x)}, "q4")["w"]
    q = prepare_params({"w": torch.from_numpy(x)}, "q4")["w"]
    assert tuple(q.codes.shape) == codes and tuple(q.scales[0].shape) == scales
    np.testing.assert_array_equal(q.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(q.scales[0].numpy().view(np.uint32),
                                  np.asarray(jq.scales[0]).view(np.uint32))
    np.testing.assert_array_equal(materialize({"w": q})["w"].numpy().view(np.uint32),
                                  np.asarray(j_materialize({"w": jq})["w"]).view(np.uint32))
    assert weight_report({"w": torch.from_numpy(x)}, "q4")["total_serve_bytes"] == \
        j_weight_report({"w": jnp.asarray(x)}, "q4")["total_serve_bytes"] == q.nbytes()


def test_engine_with_odd_vocab_matches_reference_engine():
    """A q4 engine whose embed and head have no kernel view (vocab 257):
    its tree equals the reference's, and its streams agree with the
    reference engine's as the kernel-view engine's do."""
    jcfg = dataclasses.replace(J_TINY, vocab_size=257)
    cfg = dataclasses.replace(TINY, vocab_size=257)
    jparams = jax.jit(lambda k: j_init_model(k, jcfg)[0])(jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jflat = serving_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.jit(lambda p: j_prepare_params(p, "q4"))(jparams)),
        device="cpu")
    for path in ("embed", "head"):
        ours = prepare_params({path: tparams[path]}, "q4")[path]
        assert torch.equal(ours.codes, jflat[path].codes), path
        assert torch.equal(ours.scales[0], jflat[path].scales[0]), path
    prompts = [[5, 6, 7, 8, 9, 10, 11], [12, 13], [256, 15, 16]]
    mix = lambda i: dict(temperature=0.8, top_k=10) if i % 2 else {}
    jeng = JServeEngine(jcfg, jparams, max_batch=2, s_max=64, weights="q4", drain_every=4)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=12, **mix(i)) for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    eng = ServeEngine(cfg, tparams, max_batch=2, s_max=64, weights="q4", drain_every=4)
    treqs = [Request(rid=i, prompt=p, max_new_tokens=12, **mix(i)) for i, p in enumerate(prompts)]
    for r in treqs:
        eng.submit(r)
    eng.run()
    same = total = 0
    for j, t in zip(jreqs, treqs):
        assert len(t.output) == len(j.output) == 12 and t.output[:8] == j.output[:8], (j, t)
        assert all(0 <= x < 257 for x in t.output)
        same += sum(a == b for a, b in zip(j.output, t.output))
        total += len(j.output)
    assert same >= 0.9 * total, (same, total)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _serve(tparams, reqs, max_batch, weights="bf16", drain_every=4):
    eng = ServeEngine(TINY, tparams, max_batch=max_batch, s_max=64, weights=weights,
                      drain_every=drain_every)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng


def test_engine_streams_match_reference_engine(tiny):
    jparams, tparams = tiny
    prompts = [[5, 6, 7, 8, 9, 10, 11], [12, 13], [14, 15, 16], [17], [18, 19, 20, 21, 22]]
    mix = lambda i: dict(temperature=0.8, top_k=10) if i % 2 else {}  # odd rids sample
    jeng = JServeEngine(J_TINY, jparams, max_batch=2, s_max=64, weights="q4", drain_every=4)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=12, **mix(i)) for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    treqs = [Request(rid=i, prompt=p, max_new_tokens=12, **mix(i)) for i, p in enumerate(prompts)]
    _serve(tparams, treqs, 2, weights="q4")
    same = total = 0
    for j, t in zip(jreqs, treqs):
        assert len(t.output) == len(j.output) == 12 and t.output[:8] == j.output[:8], (j, t)
        same += sum(a == b for a, b in zip(j.output, t.output))
        total += len(j.output)
    assert same >= 0.9 * total, (same, total)


def test_engine_streams_reproducible_and_slot_invariant(tiny):
    _, tparams = tiny

    def serve(order, max_batch):
        reqs = {i: Request(rid=i, prompt=[1 + i, 2 + i, 3 + i], max_new_tokens=6,
                           temperature=0.8, top_k=10) for i in order}
        _serve(tparams, [reqs[i] for i in order], max_batch, weights="q4")
        return {i: r.output for i, r in reqs.items()}

    a = serve([0, 1, 2, 3, 4], 2)
    b = serve([4, 3, 2, 1, 0], 3)  # reshuffled, other slot count
    c = serve([0, 1, 2, 3, 4], 2)  # restart
    assert a == b == c
    assert len({tuple(v) for v in a.values()}) > 1  # streams differ by rid

"""q4 / bf16 serving of the port's dense variants (qwen3-4b, chatglm3-6b,
gemma2-2b) against the JAX reference, on the CPU, at ``reduced_config``
with the reference's own parameters carried across (``convert``).

Held to:

* ``prepare_params``: codes and scales bit-equal leaf by leaf (the tied
  ``embed``, the qk-norm scales and gemma2's sandwich-norm scales
  included), bf16 leaves equal, ``materialize`` equal; ``weight_report``
  rows and totals equal;
* ``prefill_with_cache`` and teacher-forced ``decode_step`` logits from the
  q4 weights: within 2e-2 absolute (``tests/test_torch_serving.py``'s
  bound: both compute in bf16 but round their products at other places),
  and the caches' positions equal, for every unit and sub;
* the engine's greedy q4 streams against the reference engine's (same
  requests, two slots, backfill): equal up to the first step where they
  part, which must be a near tie of the port's own logits (random weights
  give near ties; measured: chatglm3's third stream parts at its fifth
  token, where the port's two best logits are equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_serve_cache as j_init_serve_cache  # noqa: E402
from repro.models import prefill_with_cache as j_prefill_with_cache  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import materialize as j_materialize  # noqa: E402
from repro.serve import prepare_params as j_prepare_params  # noqa: E402
from repro.serve import weight_report as j_weight_report  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax, serving_params_from_jax  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.models import decode_step, init_serve_cache, prefill_with_cache  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Request,
    ServeEngine,
    materialize,
    prepare_params,
    weight_report,
)
from torch_ref import ref_params  # noqa: E402

torch.set_num_threads(1)

NEW_ARCHS = ["qwen3-4b", "chatglm3-6b", "gemma2-2b"]
LOGIT_ATOL = 2e-2
PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22], [10, 11, 12],
           [13]]


def _params(arch):
    jparams = ref_params(j_reduced(arch))
    return jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("mode", ["q4", "bf16"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prepare_params_and_report_match_reference(arch, mode):
    jparams, tparams = _params(arch)
    jtree = jax.jit(lambda p: j_prepare_params(p, mode))(jparams)
    jflat = serving_params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), device="cpu")
    mine = prepare_params(tparams, mode)
    assert list(mine) == list(jflat)
    quantized = []
    for path, ours in mine.items():
        theirs = jflat[path]
        if isinstance(theirs, QuantizedTensor):
            quantized.append(path)
            assert isinstance(ours, QuantizedTensor) and ours.shape == theirs.shape, path
            assert torch.equal(ours.codes, theirs.codes), path
            assert torch.equal(ours.scales[0], theirs.scales[0]), path
        else:
            assert ours.dtype == theirs.dtype and torch.equal(ours, theirs), path
    if mode == "q4":
        assert "embed" in quantized  # tied in gemma2: the head is its transpose
        assert ("head" in quantized) == (arch != "gemma2-2b")
    jmat = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.jit(j_materialize)(jtree)),
                           device="cpu")
    for path, x in materialize(mine).items():
        assert torch.equal(x.float(), jmat[path]), path
    t, j = weight_report(tparams, mode), j_weight_report(jparams, mode)
    for key in ("total_serve_bytes", "total_bf16_bytes", "quantized_leaves", "n_leaves"):
        assert t[key] == j[key], key
    assert [(r["path"], r["serve_bytes"]) for r in t["leaves"]] == \
        [(r["path"], r["serve_bytes"]) for r in j["leaves"]]


def _padded(prompts):
    S = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), S), np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    return toks, np.array([len(p) for p in prompts], np.int32)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    jparams, _ = _params(arch)
    jq = jax.jit(lambda p: j_materialize(j_prepare_params(p, "q4")))(jparams)
    tq = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    toks, lens = _padded(PROMPTS)
    j_prefill = jax.jit(lambda p, t, n, c: j_prefill_with_cache(p, jcfg, t, n, c))
    j_decode = jax.jit(lambda p, c, t, n: j_decode_step(p, jcfg, c, t, n))
    jl, jc = j_prefill(jq, jnp.asarray(toks), jnp.asarray(lens),
                       j_init_serve_cache(jcfg, len(PROMPTS), 256))
    with torch.no_grad():
        tl, tc = prefill_with_cache(tq, cfg, torch.from_numpy(toks).long(),
                                    torch.from_numpy(lens),
                                    init_serve_cache(cfg, len(PROMPTS), 256, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    pos = lens.copy()
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for t in range(4):
        jl, jc = j_decode(jq, jc, jnp.asarray(tok), jnp.asarray(pos + t))
        with torch.no_grad():
            tl, tc = decode_step(tq, cfg, tc, torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos + t))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert len(tc) == len(jc)
    for tu, ju in zip(tc, jc):
        assert sorted(tu) == sorted(ju)
        for sub in tu:
            np.testing.assert_array_equal(tu[sub].pos.numpy(), np.asarray(ju[sub].pos))


def _top2_margin(params, cfg, tokens):
    """The gap between the two largest next-token logits after ``tokens``."""
    with torch.no_grad():
        logits, _ = prefill_with_cache(params, cfg, torch.tensor([tokens]),
                                       torch.tensor([len(tokens)]),
                                       init_serve_cache(cfg, 1, 256, device="cpu"))
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_engine_streams_match_reference_engine(arch):
    """Greedy q4 streams of the two engines (two slots, backfill) agree up to
    the first step where they part, and they part only at a near tie: there
    the port's own two best logits, after the reference's stream so far,
    lie within twice the logits' tolerance."""
    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    jparams, tparams = _params(arch)
    prompts = [[5, 6, 7, 8, 9, 10, 11] * 3, [12, 13], [14, 15, 16], [17]]
    jeng = JServeEngine(jcfg, jparams, max_batch=2, s_max=256, weights="q4", drain_every=4)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=12) for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    eng = ServeEngine(cfg, tparams, max_batch=2, s_max=256, weights="q4", drain_every=4)
    treqs = [Request(rid=i, prompt=p, max_new_tokens=12) for i, p in enumerate(prompts)]
    for r in treqs:
        eng.submit(r)
    eng.run()
    q4 = materialize(prepare_params(tparams, "q4"))
    same = 0
    for j, t in zip(jreqs, treqs):
        assert len(t.output) == len(j.output) == 12
        d = next((i for i, (a, b) in enumerate(zip(j.output, t.output)) if a != b), 12)
        same += d
        if d < 12:
            margin = _top2_margin(q4, cfg, j.prompt + j.output[:d])
            print(f"{arch} stream {j.rid} parts at token {d}: top-2 margin {margin:.3g}")
            assert margin < 2 * LOGIT_ATOL, (arch, j.rid, d, margin)
    assert same >= 24, same  # most of the 48 tokens before any parting

"""q4 / bf16 serving of the port's recurrent archs (xlstm-125m, hymba-1.5b)
against the JAX reference, on the CPU, at ``reduced_config`` with the
reference's own parameters carried across (``convert``): the checks of
``tests/test_torch_archs_serve.py`` on caches that hold recurrent states.

* ``prepare_params``: codes and scales bit-equal leaf by leaf, bf16 leaves
  equal, ``materialize`` equal; ``weight_report`` rows and totals equal;
* ``prefill_with_cache`` and teacher-forced ``decode_step`` logits from the
  q4 weights within 2e-2 absolute (``tests/test_torch_serving.py``'s
  bound; measured at most 3.9e-3), the caches' K/V positions equal and
  their recurrent states (fp32) within 2e-2 of the reference's scale
  (measured at most 2.0e-3: bf16 projections feed them);
* the engine's greedy q4 streams against the reference engine's, three
  slots and five requests of different lengths, so that later waves admit
  one request beside live slots (the prefill's cache merge must leave the
  live slots' recurrent states alone): equal up to the first step where
  they part, which must be a near tie of the port's own logits.

Also here, with ``tests/test_torch_serving.py``'s ``TINY`` engine: retire
and backfill without a KV leak, early EOS and the serve CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import (  # noqa: E402
    decode_step as j_decode_step,
    init_serve_cache as j_init_serve_cache,
    prefill_with_cache as j_prefill_with_cache,
)
from repro.serve import (  # noqa: E402
    materialize as j_materialize,
    prepare_params as j_prepare_params,
    Request as JRequest,
    ServeEngine as JServeEngine,
)
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import quant4  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import decode_step, init_serve_cache, prefill_with_cache  # noqa: E402
from repro_torch.serve import materialize, prepare_params, Request, ServeEngine  # noqa: E402
from test_torch_archs_serve import (  # noqa: E402
    _padded,
    _params,
    _top2_margin,
    LOGIT_ATOL,
    PROMPTS,
    test_prepare_params_and_report_match_reference as _prepare_and_report,
)
from test_torch_serving import _serve, tiny  # noqa: E402

torch.set_num_threads(1)

RECURRENT_ARCHS = ["xlstm-125m", "hymba-1.5b"]
STATE_RTOL = 2e-2


@pytest.mark.parametrize("mode", ["q4", "bf16"])
@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_prepare_params_and_report_match_reference(arch, mode):
    _prepare_and_report(arch, mode)


def _cache_leaves(tree):
    """(name, tensor) of a unit's cache, keys sorted as JAX flattens dicts."""
    if isinstance(tree, torch.Tensor):
        return [("", tree)]
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    else:
        items = list(zip(tree._fields, tree))
    return [(f"{k}/{n}".rstrip("/"), t) for k, v in items for n, t in _cache_leaves(v)]


def _compare_caches(tc, jc):
    assert len(tc) == len(jc)
    for tu, ju in zip(tc, jc):
        assert sorted(tu) == sorted(ju)
        for sub in tu:
            mine = _cache_leaves(tu[sub])
            theirs = jax.tree_util.tree_leaves(ju[sub])
            assert len(mine) == len(theirs), sub
            for (name, a), b in zip(mine, theirs):
                b = np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16 else b)
                assert tuple(a.shape) == b.shape, (sub, name)
                if name.endswith("pos"):
                    np.testing.assert_array_equal(a.numpy(), b)
                elif a.dtype == torch.float32:  # a recurrent state
                    scale = max(float(np.abs(b).max()), 1.0)
                    err = float(np.abs(a.numpy() - np.where(b < -1e29, a.numpy(), b)).max())
                    assert err <= STATE_RTOL * scale, (sub, name, err, scale)
                    assert np.array_equal(a.numpy() < -1e29, b < -1e29), (sub, name)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
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
    _compare_caches(tc, jc)
    pos = lens.copy()
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for t in range(4):
        jl, jc = j_decode(jq, jc, jnp.asarray(tok), jnp.asarray(pos + t))
        with torch.no_grad():
            tl, tc = decode_step(tq, cfg, tc, torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos + t))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    _compare_caches(tc, jc)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_engine_streams_match_reference_engine(arch):
    """Greedy q4 streams, three slots, five requests: request 1 ends after
    its first chunk, so the next wave admits request 3 alone beside two
    live slots, and so on. The streams agree up to the first step where
    they part, and they part only at a near tie (the port's own two best
    logits, after the reference's stream so far, within twice the logits'
    tolerance)."""
    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    jparams, tparams = _params(arch)
    prompts = [[5, 6, 7, 8, 9, 10, 11] * 3, [12, 13], [14, 15, 16], [17], [18, 19, 20, 21]]
    new_tokens = [12, 4, 8, 6, 10]

    def run(engine_cls, request_cls, cfg_, params):
        eng = engine_cls(cfg_, params, max_batch=3, s_max=256, weights="q4", drain_every=4)
        reqs = [request_cls(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, new_tokens))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return reqs

    jreqs = run(JServeEngine, JRequest, jcfg, jparams)
    treqs = run(ServeEngine, Request, cfg, tparams)
    q4 = materialize(prepare_params(tparams, "q4"))
    same = 0
    for j, t, n in zip(jreqs, treqs, new_tokens):
        assert len(t.output) == len(j.output) == n
        d = next((i for i, (a, b) in enumerate(zip(j.output, t.output)) if a != b), n)
        same += d
        if d < n:
            margin = _top2_margin(q4, cfg, j.prompt + j.output[:d])
            print(f"{arch} stream {j.rid} parts at token {d}: top-2 margin {margin:.3g}")
            assert margin < 2 * LOGIT_ATOL, (arch, j.rid, d, margin)
    assert same >= sum(new_tokens) // 2, same


def test_retire_backfill_no_kv_leak(tiny):
    _, tparams = tiny
    prompts = [[5, 6, 7, 8, 9, 10, 11], [12, 13], [14, 15, 16], [17], [18, 19, 20, 21, 22]]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    eng = _serve(tparams, reqs, 2)
    assert eng.materialize_calls["prefill"] >= 3  # three waves through two slots
    for i, r in enumerate(reqs):
        solo = Request(rid=i, prompt=prompts[i], max_new_tokens=6)
        _serve(tparams, [solo], 1)
        assert r.done and r.output == solo.output, f"rid={i} diverged after backfill"


def test_eos_retires_early(tiny):
    _, tparams = tiny
    probe = Request(rid=0, prompt=[7, 8, 9], max_new_tokens=4)
    _serve(tparams, [probe], 1)
    eos = probe.output[1]
    r0 = Request(rid=0, prompt=[7, 8, 9], max_new_tokens=4, eos_id=eos)
    r1 = Request(rid=1, prompt=[10, 11], max_new_tokens=3)
    _serve(tparams, [r0, r1], 1)
    assert r0.done and r0.output == probe.output[:2]
    solo = Request(rid=1, prompt=[10, 11], max_new_tokens=3)
    _serve(tparams, [solo], 1)
    assert r1.output == solo.output


def test_serve_cli_at_cpu_scale():
    before = dict(quant4.LAUNCHES)
    out = serve_cli.main(["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
                          "--weights", "q4", "--requests", "3", "--max-batch", "2",
                          "--max-new-tokens", "5", "--temperature", "0.8", "--top-k", "5"])
    assert out["tokens"] == 15 and all(r.done for r in out["requests"])
    assert out["weight_report"]["quantized_leaves"] == 9
    assert out["peak_bytes"] is None and out["engine"].phase_ms == {"prefill": [], "decode": []}
    assert quant4.LAUNCHES == before

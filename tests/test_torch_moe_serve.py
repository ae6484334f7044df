"""q4 / bf16 serving of the port's MoE decoders (phi3.5-moe-42b-a6.6b,
mixtral-8x7b) against the JAX reference, on the CPU, at ``reduced_config``
with the reference's own parameters carried across (``convert``): the
checks of ``tests/test_torch_archs_serve.py`` on the MoE trees.

* ``prepare_params`` and ``serving_params_from_jax``: the ``moe/*`` leaves'
  codes and scales bit-equal (the router stays fp32 at this size: 4 x 64 x
  4 elements, under the 4096-element threshold), ``materialize`` equal,
  ``weight_report`` rows and totals equal;
* ``prefill_with_cache`` and teacher-forced ``decode_step`` logits from the
  q4 weights within 2e-2 absolute (prefill: three prompts in one group of
  the reference's layout, zero padding sharing expert capacity; decode: T
  = B tokens, nothing dropped), cache positions equal. The reference's
  routing is recorded call by call and the port follows it where its own
  parts, each parting asserted to be a near tie (as in
  ``tests/test_torch_moe.py``): a parted token's logits move by more than
  the bf16 tolerance;
* the engine's greedy q4 streams against the reference engine's: equal up
  to the first step where they part, which must be a near tie of the
  port's own logits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_archs_serve import (  # noqa: E402
    LOGIT_ATOL,
    PROMPTS,
    _padded,
    _params,
)
from test_torch_archs_serve import (  # noqa: E402
    test_engine_streams_match_reference_engine as _engine_streams,
)
from test_torch_archs_serve import (  # noqa: E402
    test_prepare_params_and_report_match_reference as _prepare_and_report,
)
from test_torch_moe import _follow_reference_routes, _routes_of_reference  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_serve_cache as j_init_serve_cache  # noqa: E402
from repro.models import prefill_with_cache as j_prefill_with_cache  # noqa: E402
from repro.serve import materialize as j_materialize  # noqa: E402
from repro.serve import prepare_params as j_prepare_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import decode_step, init_serve_cache, prefill_with_cache  # noqa: E402

torch.set_num_threads(1)

MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "mixtral-8x7b"]


@pytest.mark.parametrize("mode", ["q4", "bf16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prepare_params_and_report_match_reference(arch, mode):
    _prepare_and_report(arch, mode)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_logits_match_reference(arch, monkeypatch):
    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    jparams, _ = _params(arch)
    jq = jax.jit(lambda p: j_materialize(j_prepare_params(p, "q4")))(jparams)
    tq = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    toks, lens = _padded(PROMPTS)
    j_rec = _routes_of_reference(monkeypatch)
    parted = _follow_reference_routes(monkeypatch, j_rec)
    j_prefill = jax.jit(lambda p, t, n, c: j_prefill_with_cache(p, jcfg, t, n, c))
    j_decode = jax.jit(lambda p, c, t, n: j_decode_step(p, jcfg, c, t, n))
    jl, jc = j_prefill(jq, jnp.asarray(toks), jnp.asarray(lens),
                       j_init_serve_cache(jcfg, len(PROMPTS), 256))
    jl = np.asarray(jl)
    with torch.no_grad():
        tl, tc = prefill_with_cache(tq, cfg, torch.from_numpy(toks).long(),
                                    torch.from_numpy(lens),
                                    init_serve_cache(cfg, len(PROMPTS), 256, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_ATOL, rtol=0)
    pos = lens.copy()
    tok = np.argmax(jl, -1).astype(np.int32)
    for t in range(4):
        jl, jc = j_decode(jq, jc, jnp.asarray(tok), jnp.asarray(pos + t))
        jl = np.asarray(jl)
        with torch.no_grad():
            tl, tc = decode_step(tq, cfg, tc, torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos + t))
        np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_ATOL, rtol=0)
        tok = np.argmax(jl, -1).astype(np.int32)
    assert len(parted) == len(j_rec) == 5 * cfg.num_layers, parted
    for tu, ju in zip(tc, jc):
        np.testing.assert_array_equal(tu["sub0"].pos.numpy(), np.asarray(ju["sub0"].pos))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_streams_match_reference_engine(arch):
    _engine_streams(arch)

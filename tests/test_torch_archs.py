"""The port's dense variants against the JAX reference, on the CPU: qwen3-4b
(q/k RMS norm), chatglm3-6b (2-D RoPE) and gemma2-2b (attention and final
softcaps, sandwich norms, tied embeddings, tanh gelu, alternating windows,
so a scan unit of two subs).

Parameters are the reference's own (initialised by JAX, carried across with
``convert``). Held to:

* ``plan_scan_units``: the reference's units on its own cases
  (``tests/test_models.py``);
* ``rope_half``, ``softcap`` and the tanh gelu: within 1e-6 of the
  reference's (fp32 both sides; bf16 inputs give bf16 outputs within one
  bf16 rounding);
* the reference's five dense ``DECODE_CASES``: the port's token-by-token
  decode against its own teacher-forced logits and against the reference's
  teacher-forced logits, within the reference's 0.02;
* per arch at ``reduced_config``: loss within 2e-3 relative, each gradient
  leaf within 3e-2 relative L2 error (``tests/test_torch_train.py``'s
  bf16-level tolerances), tied ``embed`` included;
* reduced gemma2's ``prefill_with_cache`` against a token-at-a-time decode
  oracle (``tests/test_serving.py``), 2e-2, and the caches' positions;
* the modality-stub archs (whisper-large-v3, qwen2-vl-2b) are refused
  where the reference refuses them: ``prefill_with_cache`` and
  ``ServeEngine`` (``ValueError``, as the reference's), the training and
  serving CLIs (``SystemExit`` with the reference's messages).

The forward passes (the decode cases, loss and gradients, gemma2's
prefill, the tanh gelu) are in ``tests/test_torch_archs_forward.py``
(pytest-xdist's ``--dist loadfile`` hands out the files with the most tests first).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import LayerSpec as JLayerSpec  # noqa: E402
from repro.models.layers import COMPUTE_DTYPE as J_COMPUTE  # noqa: E402
from repro.models.layers import rope_half as j_rope_half  # noqa: E402
from repro.models.layers import softcap as j_softcap  # noqa: E402
from repro.models.model import forward_hidden as j_forward_hidden  # noqa: E402
from repro.models.model import plan_scan_units as j_plan  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.convert import load_params, params_from_jax  # noqa: E402
from repro_torch.models import (  # noqa: E402
    LayerSpec,
    forward_hidden,
    init_model,
    init_serve_cache,
    named_params,
    plan_scan_units,
    prefill_with_cache,
)
from repro_torch.models.layers import COMPUTE_DTYPE, rope_half, softcap  # noqa: E402

torch.set_num_threads(1)

NEW_ARCHS = ["qwen3-4b", "chatglm3-6b", "gemma2-2b"]


def _port_model(cfg, jparams):
    model = init_model(cfg, device="cpu")
    load_params(model, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                       device="cpu"))
    return model


# ---------------------------------------------------------------------------
# configs and scan units
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    """Every registered arch and its reduced config, field by field (the
    port's fields are a subset of the reference's)."""
    from repro.configs import get_config as j_get_config

    for name in ARCHS:
        for mine, theirs in ((get_config(name), j_get_config(name)),
                             (reduced_config(name), j_reduced(name))):
            for f in mine.__dataclass_fields__:
                want = getattr(theirs, f)
                if f in ("blocks", "encoder_blocks"):
                    want = tuple(LayerSpec(b.kind, b.window) for b in want)
                assert getattr(mine, f) == want, (name, f)


def _plan_both(blocks):
    mine = plan_scan_units(tuple(LayerSpec(b.kind, b.window) for b in blocks))
    theirs = j_plan(blocks)
    return ([(tuple((s.kind, s.window) for s in u.pattern), u.repeat) for u in mine],
            [(tuple((s.kind, s.window) for s in u.pattern), u.repeat) for u in theirs])


@pytest.mark.parametrize("case", ["periodic", "runs", "uniform", "gemma2", "reduced_gemma2"])
def test_plan_scan_units_matches_reference(case):
    a, b = JLayerSpec("dense", 8), JLayerSpec("dense", 0)
    g, s = JLayerSpec("hymba", 0), JLayerSpec("hymba", 8)
    blocks = {
        "periodic": (a, b) * 13,
        "runs": (g,) + (s,) * 14 + (g,) + (s,) * 15 + (g,),
        "uniform": (b,) * 32,
        "gemma2": (JLayerSpec("dense", 4096), b) * 13,
        "reduced_gemma2": j_reduced("gemma2-2b").blocks,
    }[case]
    mine, theirs = _plan_both(blocks)
    assert mine == theirs
    if case == "gemma2":
        assert mine == [((("dense", 4096), ("dense", 0)), 13)]
    if case == "runs":
        assert [r for _, r in mine] == [1, 14, 1, 15, 1]


def test_gemma2_stacks_and_tied_head():
    """gemma2-2b: one unit of two subs of 13 layers, no head leaf, 4-D
    attention leaves of head_dim 256 and sandwich-norm scales (shapes on
    the meta device)."""
    params = named_params(init_model(get_config("gemma2-2b"), device="meta"))
    assert "head" not in params and tuple(params["embed"].shape) == (256000, 2304)
    for sub in ("sub0", "sub1"):
        p = f"decoder/0/{sub}/"
        assert tuple(params[p + "attn/wq"].shape) == (13, 2304, 8, 256)
        assert tuple(params[p + "post1"].shape) == (13, 2304)
    assert not any(k.startswith("decoder/1/") for k in params)
    qwen = named_params(init_model(get_config("qwen3-4b"), device="meta"))
    assert tuple(qwen["decoder/0/sub0/attn/q_norm"].shape) == (36, 128)


@pytest.mark.parametrize("entry", ["prefill_with_cache", "ServeEngine", "train CLI",
                                   "serve CLI"])
@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-2b"])
def test_modality_archs_are_refused_where_the_reference_refuses(arch, entry):
    from repro.models import prefill_with_cache as j_prefill_with_cache
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.launch import serve, train
    from repro_torch.serve import ServeEngine

    cfg, jcfg = reduced_config(arch), j_reduced(arch)
    if entry == "prefill_with_cache":
        params = named_params(init_model(cfg, device="cpu"))
        toks, lens = torch.zeros((1, 4), dtype=torch.int64), torch.tensor([4])
        with pytest.raises(ValueError, match="serves token-decoder archs only"):
            prefill_with_cache(params, cfg, toks, lens, init_serve_cache(cfg, 1, 256, "cpu"))
        with pytest.raises(ValueError, match="serves token-decoder archs only"):
            j_prefill_with_cache({}, jcfg, jnp.zeros((1, 4), jnp.int32), jnp.array([4]), [])
    elif entry == "ServeEngine":
        params = {k: p.detach() for k, p in named_params(init_model(cfg, device="cpu")).items()}
        with pytest.raises(ValueError, match="ServeEngine serves token-decoder archs only"):
            ServeEngine(cfg, params)
        with pytest.raises(ValueError, match="ServeEngine serves token-decoder archs only"):
            JServeEngine(jcfg, {})
    elif entry == "train CLI":
        with pytest.raises(SystemExit, match=f"{arch}: modality-stub arch"):
            train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1"])
    else:
        with pytest.raises(SystemExit, match=f"{arch}: token-decoder archs only in this CLI"):
            serve.main(["--arch", arch, "--reduced", "--device", "cpu"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_half_and_softcap_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 5)).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(j_rope_half(jx, jnp.asarray(pos), 10000.0).astype(jnp.float32))
    got = rope_half(tx, torch.from_numpy(pos).long(), 10000.0).float().numpy()
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got, want, rtol=tol, atol=1e-6)
    np.testing.assert_array_equal(got[..., 8:], tx[..., 8:].float().numpy())  # pass-through
    logits = (rng.normal(size=(4, 64)) * 80).astype(np.float32)
    want = np.asarray(j_softcap(jnp.asarray(logits).astype(dtype), 30.0).astype(jnp.float32))
    got = softcap(torch.from_numpy(logits).to(getattr(torch, dtype)), 30.0).float().numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=1e-6)


# ---------------------------------------------------------------------------
# decode parity: the reference's dense DECODE_CASES
# ---------------------------------------------------------------------------

DECODE_CASES = {
    "dense_gqa": dict(blocks=((("dense", 0),) * 2)),
    "swa": dict(blocks=((("dense", 8),) * 2)),
    "softcap_sandwich": dict(blocks=(("dense", 8), ("dense", 0)), attn_softcap=30.0,
                             final_softcap=20.0, sandwich_norm=True),
    "qk_norm": dict(blocks=((("dense", 0),) * 2), qk_norm=True),
    "rope2d": dict(blocks=((("dense", 0),) * 2), rope_variant="rope2d"),
}


def _port_full_logits(model, tokens):
    x = forward_hidden(model, {"tokens": tokens})
    logits = torch.einsum("bsd,dv->bsv", x.to(COMPUTE_DTYPE),
                          model.head_weight().to(COMPUTE_DTYPE)).to(torch.float32)
    if model.cfg.final_softcap > 0:
        logits = softcap(logits, model.cfg.final_softcap)
    return logits


def _j_full_logits(params, cfg, tokens):
    x, _ = j_forward_hidden(params, cfg, {"tokens": tokens})
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = jnp.einsum("bsd,dv->bsv", x.astype(J_COMPUTE),
                        head.astype(J_COMPUTE)).astype(jnp.float32)
    if cfg.final_softcap > 0:
        logits = j_softcap(logits, cfg.final_softcap)
    return logits


# ---------------------------------------------------------------------------
# per arch at reduced_config: loss and gradients
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# serving: prefill with cache against the decode oracle (reduced gemma2)
# ---------------------------------------------------------------------------

"""The dense archs' forward passes against the reference: loss and
gradients, decode against teacher forcing, gemma2's prefill against its
decode oracle and the tanh GELU (``tests/test_torch_archs.py``'s helpers;
see its docstring)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import numpy as np  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import (  # noqa: E402
    decode_step as j_decode_step,
    init_model as j_init,
    init_serve_cache as j_init_serve_cache,
    LayerSpec as JLayerSpec,
    loss_fn as j_loss_fn,
    ModelConfig as JModelConfig,
)
from repro.models.layers import COMPUTE_DTYPE as J_COMPUTE  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    init_serve_cache,
    LayerSpec,
    loss_fn,
    ModelConfig,
    named_params,
    prefill_with_cache,
)
from repro_torch.models.blocks import apply_mlp  # noqa: E402
from repro_torch.models.layers import COMPUTE_DTYPE  # noqa: E402
from test_torch_archs import (  # noqa: E402
    _j_full_logits,
    _port_full_logits,
    _port_model,
    DECODE_CASES,
    NEW_ARCHS,
)
from torch_ref import ref_params  # noqa: E402

torch.set_num_threads(1)


def test_tanh_gelu_matches_jax_gelu():
    """``apply_mlp(act="gelu")`` is ``jax.nn.gelu``'s default (tanh) form,
    not the erf form."""
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(erf - want)) > 1e-4  # the erf form would be wrong
    # through the MLP: an identity-ish mlp exposes the activation
    p = {"w1": torch.eye(8), "w2": torch.eye(8)}
    h = torch.from_numpy(x[:8].copy())[None, None]
    out = apply_mlp(p, h.to(COMPUTE_DTYPE), "gelu").float().numpy()[0, 0]
    np.testing.assert_allclose(out, np.asarray(jax.nn.gelu(
        jnp.asarray(x[:8]).astype(J_COMPUTE)).astype(jnp.float32)), atol=2e-2)


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
        full = _port_full_logits(model, torch.from_numpy(tokens).long()).numpy()
        params = {k: p.detach() for k, p in named_params(model).items()}
        caches = init_serve_cache(cfg, B, 256, device="cpu")
        dec = []
        for t in range(S):
            logits, caches = decode_step(params, cfg, caches, torch.from_numpy(tokens[:, t]).long(),
                                         torch.full((B,), t, dtype=torch.int64))
            dec.append(logits.numpy())
    dec = np.stack(dec, axis=1)
    jfull = np.asarray(jax.jit(lambda p, t: _j_full_logits(p, jcfg, t))(jparams,
                                                                         jnp.asarray(tokens)))
    assert np.max(np.abs(full - dec)) < 0.02, (case, np.max(np.abs(full - dec)))
    assert np.max(np.abs(full - jfull)) < 0.02, (case, np.max(np.abs(full - jfull)))
    # the reference's own decode, for the cache regime
    j_decode = jax.jit(lambda p, c, tok, pos: j_decode_step(p, jcfg, c, tok, pos))
    jc = j_init_serve_cache(jcfg, B, 256)
    jdec = []
    for t in range(S):
        jl, jc = j_decode(jparams, jc, jnp.asarray(tokens[:, t]), jnp.full((B,), t, jnp.int32))
        jdec.append(np.asarray(jl))
    assert np.max(np.abs(dec - np.stack(jdec, axis=1))) < 0.02


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg = j_reduced(arch)
    jparams, _ = j_init(jax.random.PRNGKey(0), jcfg)
    model = _port_model(reduced_config(arch), jparams)
    b = SyntheticLM(DataConfig(512, 32, 4)).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(p, jcfg, b), has_aux=True))(
        jparams)
    tl, _ = loss_fn(model, {k: torch.from_numpy(v) for k, v in b.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), device="cpu")
    mine = named_params(model)
    assert list(mine) == list(jflat)  # the reference's leaf order
    for k, p in mine.items():
        ref = jflat[k].numpy()
        err = np.linalg.norm(p.grad.numpy() - ref) / max(np.linalg.norm(ref), 1e-12)
        assert err < 3e-2, (k, err)


def test_gemma2_prefill_matches_decode_oracle():
    """Windowed (16 of 256 slots) and global subs, softcaps, tied head:
    one-shot prefill of right-padded prompts against a token-at-a-time
    decode, then four greedy steps from both caches."""
    cfg = reduced_config("gemma2-2b")
    jparams, _ = j_init(jax.random.PRNGKey(0), j_reduced("gemma2-2b"))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    prompts = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23], [9, 10]]
    B, S = len(prompts), max(len(p) for p in prompts)
    with torch.no_grad():
        oracle = init_serve_cache(cfg, B, 256, device="cpu")
        assert oracle[0]["sub0"].k.shape[2] == 256 and oracle[0]["sub1"].k.shape[2] == 256
        last = [None] * B
        for t in range(S):
            toks = torch.tensor([p[min(t, len(p) - 1)] for p in prompts])
            logits, oracle = decode_step(params, cfg, oracle, toks, torch.full((B,), t))
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
        np.testing.assert_allclose(l_batch.numpy(), l_oracle.numpy(), atol=2e-2, rtol=0)
        # the oracle wrote its row-1 repeats at positions past the prompt:
        # compare the slots the prompt owns
        for sub in ("sub0", "sub1"):
            pb = batch[0][sub].pos
            assert int(pb[:, 0].max()) == S - 1 and int(pb[:, 1].max()) == 1, sub
        pos = lens.clone()
        tok_a = torch.argmax(l_oracle, -1)
        tok_b = torch.argmax(l_batch, -1)
        for t in range(4):
            la, oracle = decode_step(params, cfg, oracle, tok_a, pos + t)
            lb, batch = decode_step(params, cfg, batch, tok_b, pos + t)
            np.testing.assert_allclose(lb.numpy(), la.numpy(), atol=2e-2, rtol=0)
            tok_a, tok_b = torch.argmax(la, -1), torch.argmax(lb, -1)
            assert torch.equal(tok_a, tok_b)

"""The port's MoE layer and MoE decoders (phi3.5-moe-42b-a6.6b, mixtral-8x7b)
against the JAX reference, on the CPU.

Parameters are the reference's own (initialised by JAX, carried across with
``convert``); inputs come from numpy with a seed. Held to:

* ``moe_apply`` in three cases: random inputs, a router skewed so that one
  expert overflows its capacity, and duplicated router columns whose logits
  tie exactly (the lower expert index wins, as ``jax.lax.top_k``). The
  routing (each assignment's expert and slot, -1 where dropped) equals the
  reference's exactly; where an expert differs, the test requires a near
  tie (the logits of the two experts at the first differing place within
  two bf16 ulps, or within twice the largest logit difference between the
  two frameworks in that call) and leaves that token out of the comparison. Output within
  two bf16 roundings of its scale, aux within 1e-6, and the gradients to
  ``x`` and to all four leaves within 3e-2 relative L2 error;
* the reference's ``moe`` entry of ``DECODE_CASES`` (``tests/test_models.py``):
  the port's token-by-token decode against its own teacher-forced logits
  and against the reference's, within the reference's 0.08;
* per arch at ``reduced_config`` with a batch of two groups (4 x 32 tokens,
  groups of 64): loss within 2e-3 relative, aux within 1e-5, each gradient
  leaf within 3e-2 (``tests/test_torch_archs.py``'s tolerances). The
  router logits of random weights are small (std ~0.16), so bf16 near ties
  are common and inputs that differ by roundings upstream part some
  choices: each parting is shown to be a near tie, and the port then
  follows the reference's choice for the rest of the pass;
* ``prefill_with_cache`` of a part-filled wave (the engine's layout: rows
  of no tokens and zero padding in one group with the real tokens, sharing
  expert capacity) against the reference's, logits within 2e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import LayerSpec as JLayerSpec  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.models import init_serve_cache as j_init_serve_cache  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models import prefill_with_cache as j_prefill  # noqa: E402
from repro.models.layers import COMPUTE_DTYPE as J_COMPUTE  # noqa: E402
from repro.models.model import forward_hidden as j_forward_hidden  # noqa: E402
from repro.models.moe import init_moe as j_init_moe  # noqa: E402
from repro.models.moe import moe_apply as j_moe_apply  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import load_params, params_from_jax  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import (  # noqa: E402
    LayerSpec,
    ModelConfig,
    decode_step,
    forward_hidden,
    init_model,
    init_serve_cache,
    loss_fn,
    named_params,
    prefill_with_cache,
)
from repro_torch.models.layers import COMPUTE_DTYPE  # noqa: E402
from repro_torch.models.moe import moe_apply, moe_capacity, moe_choose, moe_slots  # noqa: E402
from torch_ref import ref_params  # noqa: E402

torch.set_num_threads(1)

MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "mixtral-8x7b"]
BF16_ULP = 2.0 ** -7  # relative spacing of bf16 at 1


def _port_model(cfg, jparams):
    model = init_model(cfg, device="cpu")
    load_params(model, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                       device="cpu"))
    return model


def _j_route(router, xg, k, C):
    """The reference's routing lines (``repro/models/moe.py:59-73``) with
    each assignment's slot read out: (logits, experts, slots: -1 dropped)."""
    E = router.shape[1]
    logits = jnp.einsum("gtd,de->gte", xg.astype(J_COMPUTE),
                        router.astype(J_COMPUTE)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_idx = jax.lax.top_k(probs, k)
    G, T = xg.shape[:2]
    flat = jax.nn.one_hot(top_idx, E, dtype=jnp.float32).reshape(G, T * k, E)
    pos = jnp.sum(jnp.cumsum(flat, axis=1) * flat, axis=-1).reshape(G, T, k) - 1.0
    return logits, top_idx, jnp.where(pos < C, pos, -1.0).astype(jnp.int32)


def _ulp(v):
    """bf16's spacing at |v|."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


def _moe_case(case):
    """(params (numpy), x (B, S, D) float32) for one moe_apply case; D 64, F
    256, E 4, groups of 64 tokens."""
    rng = np.random.default_rng(5)
    jp, _ = j_init_moe(jax.random.PRNGKey(3), 64, 256, 4)
    p = {k: np.array(v) * 10.0 for k, v in jp.items()}  # outputs of order one
    x = rng.normal(size=(4, 32, 64)).astype(np.float32)
    if case == "overflow":
        # every token's largest logit is expert 2's, far above the others:
        # 128 tokens in two groups of 64 against a capacity of 40
        x += 1.0
        p["router"][:, 2] += 0.5
    elif case == "ties":
        p["router"][:, 1] = p["router"][:, 0]
        p["router"][:, 3] = p["router"][:, 2]
    return p, x


@pytest.mark.parametrize("case", ["random", "overflow", "ties"])
def test_moe_apply_matches_reference(case):
    p, x = _moe_case(case)
    k, gs = 2, 64
    B, S, D = x.shape
    E = p["router"].shape[1]
    T, C = moe_capacity(B * S, k, E, group_size=gs)
    assert (T, C) == (64, 40)
    w = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

    jx = jnp.asarray(x).astype(J_COMPUTE)
    jparams = {n: jnp.asarray(v) for n, v in p.items()}

    def jloss(params, xx):
        out, aux = j_moe_apply(params, xx, top_k=k, group_size=gs)
        return jnp.sum(out.astype(jnp.float32) * w) + aux, (out, aux)

    (_, (jout, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jparams, jx)
    logits, jidx, jslot = (np.asarray(a) for a in jax.jit(
        lambda r, xx: _j_route(r, xx.reshape(-1, T, D), k, C))(jparams["router"], jx))

    tp = {n: torch.from_numpy(v.copy()).requires_grad_(True) for n, v in p.items()}
    tx = torch.from_numpy(x).to(COMPUTE_DTYPE).requires_grad_(True)
    xg = tx.detach().reshape(-1, T, D)
    _, _, tidx = moe_choose(tp["router"], xg, k)
    tslot = moe_slots(tidx, tp["router"].shape[-1], C)
    t_logits = torch.einsum("gtd,de->gte", xg, tp["router"].detach().to(COMPUTE_DTYPE))
    tout, taux = moe_apply(tp, tx, top_k=k, group_size=gs)
    (torch.sum(tout.float() * torch.from_numpy(w)) + taux).backward()

    # routing: experts equal but at near ties; slots equal in every group
    # whose experts agree
    tidx, tslot = tidx.numpy(), tslot.numpy()
    differs = _assert_near_ties(logits, jidx, t_logits.float().numpy(), tidx)  # (G, T)
    same_group = ~np.any(differs, axis=-1)
    np.testing.assert_array_equal(tslot[same_group], jslot[same_group])
    assert np.all(same_group) or case == "random"
    dropped = int(np.sum(jslot < 0))
    if case == "overflow":
        assert dropped >= 2 * (64 - C), dropped  # expert 2 takes every token
        assert np.all(jidx[..., 0] == 2)
    if case == "ties":
        tie = logits[..., 0] == logits[..., 1]
        assert tie.mean() > 0.9
        # of a tied pair the lower index comes first
        first = np.where(jidx[..., 0] < 2, jidx[..., 0], jidx[..., 0] - 2)
        assert np.all(first == 0)

    ok = ~differs.reshape(B, S)
    jout = np.asarray(jout.astype(jnp.float32))
    tout = tout.detach().float().numpy()
    scale = np.abs(jout).max()
    assert np.abs(tout - jout)[ok].max() <= 2 * BF16_ULP * scale, (case, scale)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    for n in p:
        ref = np.asarray(jg[n])
        err = np.linalg.norm(tp[n].grad.numpy() - ref) / np.linalg.norm(ref)
        assert err < 3e-2, (case, n, err)
    ref = np.asarray(jgx.astype(jnp.float32))
    err = np.linalg.norm(tx.grad.float().numpy() - ref) / np.linalg.norm(ref)
    assert err < 3e-2, (case, "x", err)


def test_moe_capacity_and_groups():
    """Capacity ``min(max(4, int(T*k*cf/E)), T)``; a token count that does not
    split into groups is refused, as the reference asserts."""
    assert moe_capacity(1024, 2, 16) == (1024, 160)  # phi3.5's training batch
    assert moe_capacity(1024, 2, 8) == (1024, 320)  # mixtral's
    assert moe_capacity(2048, 2, 16) == (2048, 320)  # a prefill of 4 x 512
    assert moe_capacity(4, 2, 16) == (4, 4)  # decode: nothing dropped
    with pytest.raises(ValueError, match="groups"):
        moe_capacity(96, 2, 4, group_size=64)


# ---------------------------------------------------------------------------
# decode parity: the reference's moe DECODE_CASES entry
# ---------------------------------------------------------------------------


def _j_full_logits(params, cfg, tokens):
    x, _ = j_forward_hidden(params, cfg, {"tokens": tokens})
    return jnp.einsum("bsd,dv->bsv", x.astype(J_COMPUTE),
                      params["head"].astype(J_COMPUTE)).astype(jnp.float32)


def test_moe_decode_matches_teacher_forced():
    common = dict(name="moe", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                  head_dim=8, d_ff=64, vocab_size=128, num_experts=4, top_k=2,
                  moe_group_size=64)
    jcfg = JModelConfig(blocks=(JLayerSpec("moe", 0),) * 2, remat=False, **common)
    cfg = ModelConfig(blocks=(LayerSpec("moe", 0),) * 2, **common)
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
            logits, caches = decode_step(params, cfg, caches,
                                         torch.from_numpy(tokens[:, t]).long(),
                                         torch.full((B,), t, dtype=torch.int64))
            dec.append(logits.numpy())
    dec = np.stack(dec, axis=1)
    jfull = np.asarray(jax.jit(lambda p, t: _j_full_logits(p, jcfg, t))(jparams,
                                                                         jnp.asarray(tokens)))
    assert np.max(np.abs(full - dec)) < 0.08, np.max(np.abs(full - dec))
    assert np.max(np.abs(full - jfull)) < 0.08, np.max(np.abs(full - jfull))


# ---------------------------------------------------------------------------
# per arch at reduced_config: loss, aux and gradients
# ---------------------------------------------------------------------------


def _assert_near_ties(j_logits, j_idx, t_logits, t_idx):
    """Tokens whose experts differ between the reference and the port; for
    each, the two experts at the first position where they differ must be
    at a near tie: their logits within two bf16 ulps in one of the two
    frameworks, or within twice the largest difference between the two
    frameworks' logits in this call (a layer's inputs differ by roundings
    upstream, and its logits with them). Returns the mask (G, T)."""
    differs = np.any(j_idx != t_idx, axis=-1)
    noise = float(np.max(np.abs(j_logits - t_logits)))
    for g, t in zip(*np.nonzero(differs)):
        j = int(np.argmax(j_idx[g, t] != t_idx[g, t]))
        a, b = j_idx[g, t, j], t_idx[g, t, j]
        gaps = [abs(lg[g, t, a] - lg[g, t, b]) for lg in (j_logits, t_logits)]
        ulps = [gap / _ulp(max(abs(lg[g, t, a]), abs(lg[g, t, b])))
                for gap, lg in zip(gaps, (j_logits, t_logits))]
        assert min(ulps) <= 2 or min(gaps) <= 2 * noise, (
            g, t, j_logits[g, t], t_logits[g, t], j_idx[g, t], t_idx[g, t], noise)
    return differs


def _routes_of_reference(monkeypatch):
    """Record each MoE layer's router logits and experts, in layer order, as
    the reference computes them (a callback from the ``moe_apply`` its
    blocks call)."""
    import repro.models.blocks as j_blocks

    rec = []
    real = j_blocks.moe_apply

    def spy(params, x, *, top_k, capacity_factor=1.25, group_size=2048):
        B, S, D = x.shape
        T = min(group_size, B * S)
        logits = jnp.einsum("gtd,de->gte", x.reshape(-1, T, D).astype(J_COMPUTE),
                            params["router"].astype(J_COMPUTE)).astype(jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
        jax.debug.callback(lambda a, b: rec.append((np.asarray(a), np.asarray(b))), logits, idx)
        return real(params, x, top_k=top_k, capacity_factor=capacity_factor,
                    group_size=group_size)

    monkeypatch.setattr(j_blocks, "moe_apply", spy)
    return rec


def _follow_reference_routes(monkeypatch, j_rec):
    """Make the port's layer ``l`` take the reference's expert choices where
    its own part from them, after asserting each parting is a near tie: the
    probabilities are the port's own (gradients flow as usual), the experts
    and so the slots the reference's. Returns the list of parted token
    counts per layer."""
    import repro_torch.models.moe as t_moe

    parted = []
    real = t_moe.moe_choose

    def spy(router, xg, top_k):
        probs, top_vals, top_idx = real(router, xg, top_k)
        j_logits, j_idx = j_rec[len(parted)]
        t_logits = torch.einsum("gtd,de->gte", xg.detach(), router.detach().to(COMPUTE_DTYPE))
        differs = _assert_near_ties(j_logits, j_idx, t_logits.float().numpy(), top_idx.numpy())
        parted.append(int(differs.sum()))
        if parted[-1]:
            top_idx = torch.from_numpy(np.asarray(j_idx, np.int64))
            top_vals = torch.gather(probs, -1, top_idx)
            top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
        return probs, top_vals, top_idx

    monkeypatch.setattr(t_moe, "moe_choose", spy)
    return parted


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    """Loss, aux and gradients at reduced_config. The reference's routing is
    recorded layer by layer; where the port's expert choice parts from it,
    the parting must sit at a near tie, and the port then follows the
    reference's choice, so the two compute the same discrete path and every
    layer of every leaf is held to 3e-2."""
    jcfg = j_reduced(arch)
    cfg = reduced_config(arch)
    assert (cfg.num_experts, cfg.top_k, cfg.moe_group_size) == (4, 2, 64)
    jparams, _ = j_init(jax.random.PRNGKey(0), jcfg)
    model = _port_model(cfg, jparams)
    j_rec = _routes_of_reference(monkeypatch)
    b = SyntheticLM(DataConfig(512, 32, 4)).batch_at(0)  # 128 tokens: two groups
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(p, jcfg, b), has_aux=True))(
        jparams)
    assert len(j_rec) == cfg.num_layers
    parted = _follow_reference_routes(monkeypatch, j_rec)
    tl, tm = loss_fn(model, {k: torch.from_numpy(v) for k, v in b.items()})
    tl.backward()
    assert len(parted) == cfg.num_layers
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
    np.testing.assert_allclose(float(tm["ce_loss"]), float(jm["ce_loss"]), rtol=2e-3)
    assert abs(float(tm["aux_loss"]) - float(jm["aux_loss"])) <= 1e-5, parted
    assert float(tm["aux_loss"]) > 0
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), device="cpu")
    mine = named_params(model)
    assert list(mine) == list(jflat)  # the reference's leaf order
    assert [k for k in mine if "/moe/" in k] == [
        f"decoder/0/sub0/moe/{n}" for n in ("router", "w1", "w2", "w3")]
    for k, p in mine.items():
        ref = jflat[k].numpy()
        err = np.linalg.norm(p.grad.numpy() - ref) / max(np.linalg.norm(ref), 1e-12)
        assert err < 3e-2, (k, err, parted)


# ---------------------------------------------------------------------------
# serving: prefill of a part-filled wave
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_part_filled_wave_matches_reference(arch):
    """The engine's prefill layout: a (max_batch, bucket) batch, rows 0 and 2
    admitted, row 1 and 3 empty (zero tokens, length 0), zero padding; 64
    tokens, one group, so padding and empty rows take expert slots beside
    the real tokens as in the reference."""
    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    jparams = ref_params(jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(2)
    B, S = 4, 16
    lens = np.array([13, 0, 5, 0])
    toks = np.zeros((B, S), np.int64)
    for b in range(B):
        toks[b, :lens[b]] = rng.integers(1, 512, size=lens[b])
    jl, jc = j_prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32), jnp.asarray(lens, jnp.int32),
                       j_init_serve_cache(jcfg, B, 256))
    with torch.no_grad():
        tl, tc = prefill_with_cache(params, cfg, torch.from_numpy(toks),
                                    torch.from_numpy(lens), init_serve_cache(cfg, B, 256,
                                                                             device="cpu"))
    real = lens > 0
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], atol=2e-2, rtol=0)
    # the caches: positions equal, K/V of the prompts within bf16 rounding
    for u, (tu, ju) in enumerate(zip(tc, jc)):
        t, j = tu["sub0"], ju["sub0"]
        np.testing.assert_array_equal(t.pos.numpy(), np.asarray(j.pos))
        for a, bb in ((t.k, j.k), (t.v, j.v)):
            a = a.float().numpy()
            bb = np.asarray(bb.astype(jnp.float32))
            np.testing.assert_allclose(a, bb, atol=4 * BF16_ULP * np.abs(bb).max(), rtol=0)

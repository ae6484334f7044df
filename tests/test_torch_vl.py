"""The port's qwen2-vl-2b path (M-RoPE over three position streams,
precomputed ``embeds`` input) against the JAX reference, on the CPU.

Inputs come from numpy with a seed; parameters are the reference's own
(initialised by JAX, carried across with ``convert``). The position
streams follow Qwen2-VL's layout for text around one image
(``vl_positions``): text tokens with t = h = w, a grid of image tokens with
t fixed and h, w walking its rows and columns, then text again after the
grid's largest position, each row shifted, so the three streams, and the
rows, differ. Held to:

* ``mrope`` at sections (4, 2, 2) (head_dim 16, the reduced config) and
  (16, 24, 24) (head_dim 128, the full one), three distinct streams: fp32
  within 1e-6 of the reference's scale, bf16 within one bf16 rounding;
* the reduced config: loss within 2e-3 relative, every gradient leaf
  within 3e-2 relative L2, the cacheless ``prefill`` within 2e-2, with the
  image layout and with the default positions (three copies of
  ``arange(S)``);
* decode: ``embeds`` equal to the bf16 embedding rows of the tokens with
  pure-text positions, teacher-forced, against a token-by-token
  ``decode_step`` (which feeds one ``pos`` to all three streams) and the
  reference's of both, within the reference's 0.02;
* ``accum_steps=2`` on a batch with ``(3, B, S)`` positions: the port's
  microbatches cut the positions on dim 1, as the reference's do; two
  production4bit SR steps against the reference's accumulated steps: loss
  within 2e-3 relative, gradient norm within 5e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro.core.optimizers.schedule import linear_warmup_linear_decay as j_sched  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_serve_cache as j_init_serve_cache  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models.layers import COMPUTE_DTYPE as J_COMPUTE  # noqa: E402
from repro.models.layers import mrope as j_mrope  # noqa: E402
from repro.models.model import forward_hidden as j_forward_hidden  # noqa: E402
from repro.train.train_loop import build_train_step as j_build  # noqa: E402
from repro.train.train_loop import make_train_state as j_make_state  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import load_params, params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.core.optimizers.schedule import linear_warmup_linear_decay  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    forward_hidden,
    init_model,
    init_serve_cache,
    loss_fn,
    named_params,
    prefill,
)
from repro_torch.models.layers import COMPUTE_DTYPE, mrope  # noqa: E402
from repro_torch.train.train_loop import build_train_step, make_train_state  # noqa: E402
from torch_ref import ref_params  # noqa: E402

torch.set_num_threads(1)

VL = "qwen2-vl-2b"
BF16_ULP = 2.0 ** -7


def vl_positions(B, S, text=4, grid=(3, 4)):
    """(3, B, S) int32 M-RoPE positions in Qwen2-VL's layout: row b has
    ``text + b`` text tokens (t = h = w), a ``grid`` of image tokens (t =
    T, h = T + row, w = T + col, T the text length), then text from T +
    max(grid) on."""
    gh, gw = grid
    out = np.zeros((3, B, S), np.int32)
    for b in range(B):
        T = text + b
        rows = [(i, i, i) for i in range(T)]
        rows += [(T, T + r, T + c) for r in range(gh) for c in range(gw)]
        nxt = T + max(gh, gw)
        rows += [(nxt + i,) * 3 for i in range(S - len(rows))]
        out[:, b] = np.array(rows[:S], np.int32).T
    return out


def vl_batch(cfg, seed, B=4, S=24):
    """numpy inputs of qwen2-vl: bf16-exact embeds (B, S, D), the image
    layout's positions, labels."""
    rng = np.random.default_rng(seed)
    embeds = (rng.normal(size=(B, S, cfg.d_model)) * 0.5).astype(np.float32)
    return {"embeds": torch.from_numpy(embeds).bfloat16().float().numpy(),
            "positions": vl_positions(B, S),
            "labels": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in b.items()}


def _port_model(cfg, jparams):
    model = init_model(cfg, device="cpu")
    load_params(model, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                       device="cpu"))
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections", [(4, 2, 2), (16, 24, 24)])
def test_mrope_matches_reference(sections, dtype):
    D = 2 * sum(sections)
    rng = np.random.default_rng(D)
    B, S, H = 2, 30, 3
    x = rng.normal(size=(B, S, H, D)).astype(np.float32)
    pos = vl_positions(B, S, text=5, grid=(4, 5))
    assert len({tuple(p.ravel()) for p in pos}) == 3  # three distinct streams
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    want = np.asarray(jax.jit(lambda a, p: j_mrope(a, p, sections))(jx, pos).astype(jnp.float32))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = mrope(tx, torch.from_numpy(pos).long(), sections)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, D)
    got = got.float().numpy()
    if dtype == "float32":
        assert np.max(np.abs(got - want)) <= 1e-6 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-6)


def test_loss_grads_and_prefill_match_reference():
    jcfg, cfg = j_reduced(VL), reduced_config(VL)
    jparams = ref_params(jcfg)
    model = _port_model(cfg, jparams)
    b = vl_batch(cfg, 1)
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
    params = {k: p.detach() for k, p in mine.items()}
    j_pre = jax.jit(lambda p, bb: j_prefill(p, jcfg, bb))
    for bb in ({"embeds": b["embeds"], "positions": b["positions"]}, {"embeds": b["embeds"]}):
        jl = np.asarray(j_pre(jparams, bb))
        with torch.no_grad():
            tl = prefill(params, cfg, _torch_batch(bb)).numpy()
        assert np.max(np.abs(tl - jl)) < 2e-2, (sorted(bb), np.max(np.abs(tl - jl)))


def test_decode_matches_teacher_forced():
    jcfg, cfg = j_reduced(VL), reduced_config(VL)
    jparams = ref_params(jcfg)
    model = _port_model(cfg, jparams)
    B, S = 2, 12
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    with torch.no_grad():
        embeds = model.embed.to(COMPUTE_DTYPE)[torch.from_numpy(tokens).long()]
        x = forward_hidden(model, {"embeds": embeds})
        full = torch.einsum("bsd,dv->bsv", x, model.embed.t().to(COMPUTE_DTYPE)).float().numpy()
        params = {k: p.detach() for k, p in named_params(model).items()}
        caches = init_serve_cache(cfg, B, 256, device="cpu")
        dec = []
        for t in range(S):
            logits, caches = decode_step(params, cfg, caches, torch.from_numpy(tokens[:, t]).long(),
                                         torch.full((B,), t, dtype=torch.int64))
            dec.append(logits.numpy())
    dec = np.stack(dec, axis=1)

    def j_full(p, tok):
        e = p["embed"].astype(J_COMPUTE)[tok]
        xx, _ = j_forward_hidden(p, jcfg, {"embeds": e})
        return jnp.einsum("bsd,dv->bsv", xx.astype(J_COMPUTE),
                          p["embed"].T.astype(J_COMPUTE)).astype(jnp.float32)

    jfull = np.asarray(jax.jit(j_full)(jparams, tokens))
    j_dec = jax.jit(lambda p, c, tok, pos: j_decode_step(p, jcfg, c, tok, pos))
    jc = j_init_serve_cache(jcfg, B, 256)
    jdec = []
    for t in range(S):
        jl, jc = j_dec(jparams, jc, jnp.asarray(tokens[:, t]), jnp.full((B,), t, jnp.int32))
        jdec.append(np.asarray(jl))
    jdec = np.stack(jdec, axis=1)
    for what, a, c in (("decode vs teacher-forced", dec, full),
                       ("teacher-forced vs reference", full, jfull),
                       ("decode vs reference decode", dec, jdec)):
        assert np.max(np.abs(a - c)) < 0.02, (what, np.max(np.abs(a - c)))


def test_accum_steps_slice_positions_on_their_batch_dim():
    jcfg, cfg = j_reduced(VL), reduced_config(VL)
    jparams = ref_params(jcfg)
    model = _port_model(cfg, jparams)
    steps = 2
    jopt = j_make("production4bit", j_sched(1e-3, 1, steps))
    topt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 1, steps))
    jstate = j_make_state(jparams, jopt, key=jax.random.PRNGKey(0))
    tstate = make_train_state(model, topt, key=sr.PRNGKey(0))
    jstep = jax.jit(j_build(jcfg, jopt, accum_steps=2))
    tstep = build_train_step(model, topt, accum_steps=2)
    for t in range(steps):
        b = vl_batch(cfg, 10 + t)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, _torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-3)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=5e-3)

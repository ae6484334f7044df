"""4-bit Shampoo in the port (port of ``tests/test_shampoo.py``): the exact
math against a numpy hand reference, the recompute schedule, the vector
fallback, the quantized factors and raw placeholders, the factor bytes and
the kernel-route contract; and the port against the JAX reference run
eagerly.

Tolerances against the reference, from the same params and grads over
three steps with a recompute every second step (steps 1 and 3), on padded
2-d blocks, a 3-d, a 1-d and a 0-d leaf:

* grafting moments (fp32, or 4-bit codes and scales): bit-equal;
* Kronecker statistics: within 1e-6 of the leaf's largest magnitude (the
  batched matmul sums in another order), codes bit-equal;
* inverse roots: within 1e-5 of the leaf's largest magnitude (LAPACK's
  eigh on each side); shampoo4bit's factor codes held to at least 99%
  agreement (the test prints what it measured: 100% on the CPU here);
* params: within 1e-6 of the leaf's largest magnitude (the directions
  carry the inverse roots' differences).

The port symmetrizes the eigh input as ``jnp.linalg.eigh`` does: a factor
dequantized from row-wise blocks is not symmetric, and reading its lower
triangle alone parts the inverse roots and their codes from the
reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.optimizers import make_optimizer as j_make  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.optimizers import (  # noqa: E402
    FACTOR_4BIT,
    adamw32,
    make_optimizer,
    optimizer_names,
    scale_by_shampoo,
    shampoo32,
    state_nbytes,
)
from repro_torch.core.optimizers.transform import FusedAdamWRoute, Replace  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.io.tree import flatten_with_keys, structure_repr  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import LayerSpec, ModelConfig, init_model, named_params  # noqa: E402

torch.set_num_threads(1)
FACTORS = ("stats_l", "stats_r", "precond_l", "precond_r")


def _params(shape=(16, 512), seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.1)}


def _run_steps(opt, params, target, steps):
    """Steps on the quadratic 0.5 * ||w - target||^2 (gradient w - target)."""
    params = {k: v.clone() for k, v in params.items()}
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        diff = params["w"] - target
        losses.append(float(0.5 * torch.sum(diff * diff)))
        params, state = opt.update({"w": diff}, state, params)
    return params, state, losses


def _inner(state):
    return state.states[0].inner


# ---------------------------------------------------------------------------
# exact math: one single-block leaf against a numpy hand reference
# ---------------------------------------------------------------------------


def test_scale_by_shampoo_matches_hand_reference():
    b1, b2, eps, ridge, floor_rel = 0.9, 0.999, 1e-8, 1e-6, 0.01
    rng = np.random.default_rng(7)
    g_all = [rng.normal(size=(8, 8)).astype(np.float64) for _ in range(3)]
    m, v, sl, sr_ = (np.zeros((8, 8)) for _ in range(4))

    def inv_quarter_root(s):
        w, u = np.linalg.eigh(s + ridge * np.eye(8))
        w = np.maximum(w, np.maximum(ridge, floor_rel * w.max()))
        return (u * w**-0.25) @ u.T

    refs = []
    for t, g in enumerate(g_all, start=1):
        bc1, bc2 = 1 - b1**t, 1 - b2**t
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        adam_dir = (m / bc1) / (np.sqrt(v / bc2) + eps)
        sl = b2 * sl + (1 - b2) * g @ g.T
        sr_ = b2 * sr_ + (1 - b2) * g.T @ g
        d = inv_quarter_root(sl / bc2) @ (m / bc1) @ inv_quarter_root(sr_ / bc2)
        refs.append(d * np.linalg.norm(adam_dir) / (np.linalg.norm(d) + 1e-30))

    tx = scale_by_shampoo(b1=b1, b2=b2, eps=eps, block_size=8, precond_every=1,
                          matrix_eps=ridge, floor_rel=floor_rel)
    params = {"w": torch.zeros((8, 8))}
    state = tx.init(params)
    for g, ref in zip(g_all, refs):
        u, state = tx.update({"w": torch.from_numpy(g.astype(np.float32))}, state, params)
        np.testing.assert_allclose(u["w"].numpy(), ref, rtol=2e-3, atol=2e-5)


def test_precond_recomputed_on_schedule():
    tx = scale_by_shampoo(block_size=8, precond_every=3)
    params = {"w": torch.zeros((8, 8))}
    state = tx.init(params)
    rng = np.random.default_rng(0)
    changed = []
    for _ in range(5):
        g = {"w": torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))}
        prev = state.precond_l["w"].clone()
        _, state = tx.update(g, state, params)
        changed.append(not torch.equal(state.precond_l["w"], prev))
    # recompute when (count - 1) % 3 == 0: counts 1 and 4
    assert changed == [True, False, False, True, False]
    assert float(torch.sum(torch.abs(state.stats_l["w"]))) > 0.0


def test_vector_params_fall_back_to_adam_direction():
    eps = 1e-8
    tx = scale_by_shampoo(eps=eps)
    params = {"b": torch.zeros((32,))}
    state = tx.init(params)
    assert tuple(state.stats_l["b"].shape) == (0,)  # an empty placeholder
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(32,)).astype(np.float32))
    u, state = tx.update({"b": g}, state, params)
    # t=1: m/bc1 == g, v/bc2 == g^2
    np.testing.assert_allclose(u["b"].numpy(), (g / (g.abs() + eps)).numpy(), rtol=1e-5)
    assert tuple(state.stats_l["b"].shape) == (0,)


def test_preconditioning_changes_the_direction():
    """The graft keeps the AdamW step's norm, not its direction."""
    params = _params((16, 512), seed=3)
    target = torch.zeros_like(params["w"])
    p_sh, _, _ = _run_steps(shampoo32(1e-2), params, target, 5)
    p_ad, _, _ = _run_steps(adamw32(1e-2), params, target, 5)
    assert not torch.allclose(p_sh["w"], p_ad["w"], atol=1e-5)


# ---------------------------------------------------------------------------
# convergence: shampoo4bit against the fp32 oracle, and both against JAX
# ---------------------------------------------------------------------------


def _jax_losses(name, params, target, steps):
    opt = j_make(name, 2e-2, weight_decay=0.0)
    p = {"w": jnp.asarray(params["w"].numpy())}
    state, upd, losses = opt.init(p), jax.jit(opt.update), []
    for _ in range(steps):
        diff = p["w"] - jnp.asarray(target.numpy())
        losses.append(float(0.5 * jnp.sum(diff * diff)))
        p, state = upd({"w": diff}, state, p)
    return losses


@pytest.mark.parametrize("name", ["shampoo32", "shampoo4bit"])
def test_shampoo_converges_on_quadratic(name):
    """Both reach the optimum; the port's last loss is the reference's
    within 1% of the first loss (the jitted reference contracts FMAs)."""
    params = _params((16, 512), seed=1)
    target = torch.full_like(params["w"], 0.5)
    _, _, low = _run_steps(make_optimizer(name, 2e-2, weight_decay=0.0), params, target, 250)
    assert np.isfinite(low).all()
    assert low[-1] < 0.02 * low[0]
    ref = _jax_losses(name, params, target, 250)
    assert low[0] == pytest.approx(ref[0], rel=1e-6)
    assert abs(low[-1] - ref[-1]) < 0.01 * low[0], (low[-1], ref[-1])


def test_shampoo4bit_tracks_fp32_oracle():
    params = _params((16, 512), seed=2)
    target = torch.full_like(params["w"], 0.5)
    _, _, base = _run_steps(make_optimizer("shampoo32", 2e-2, weight_decay=0.0), params,
                            target, 250)
    _, _, low = _run_steps(make_optimizer("shampoo4bit", 2e-2, weight_decay=0.0), params,
                           target, 250)
    assert low[-1] < 0.02 * low[0]
    assert abs(low[-1] - base[-1]) < 0.02 * low[0]


# ---------------------------------------------------------------------------
# the port against the reference, leaf by leaf
# ---------------------------------------------------------------------------


def _small_tree():
    rng = np.random.default_rng(0)
    n = lambda *s: (rng.normal(size=s) * 0.02).astype(np.float32)
    # (40, 300): padded blocks of 40 x 128; (2, 24, 160): leading dims merge
    return {"w2d": n(40, 300), "w3d": n(2, 24, 160), "v1d": n(5000), "s0d": np.float32(0.5)}


def _codes(x):
    return np.stack([x & 15, x >> 4])


@pytest.mark.parametrize("name,ov,sr_seed", [
    ("shampoo32", {}, None), ("shampoo4bit", {}, None),
    ("shampoo4bit", {"stochastic_rounding": True}, 4),
], ids=["shampoo32", "shampoo4bit", "shampoo4bit_sr"])
def test_shampoo_matches_reference(name, ov, sr_seed):
    tree = _small_tree()
    jopt = j_make(name, 1e-3, precond_every=2, **ov)
    topt = make_optimizer(name, 1e-3, precond_every=2, **ov)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, tree), params_from_jax(tree, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(1)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=np.shape(p)) * 1e-2).astype(np.float32), tree)
        jkey = jax.random.fold_in(jax.random.PRNGKey(sr_seed), step) if sr_seed else None
        tkey = sr.fold_in(sr.PRNGKey(sr_seed), step) if sr_seed else None
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp, key=jkey)
        tp, ts = topt.update(params_from_jax(grads, device="cpu"), ts, tp, key=tkey)
    assert structure_repr(ts) == str(jax.tree_util.tree_structure(js))
    tl = [(k, v.numpy()) for k, v in flatten_with_keys(ts)]
    jl = [(jax.tree_util.keystr(p), np.asarray(v))
          for p, v in jax.tree_util.tree_flatten_with_path(js)[0]]
    assert [k for k, _ in tl] == [k for k, _ in jl]
    agreement = {}
    for (k, a), (_, b) in zip(tl, jl):
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype == np.uint8:
            agreement[k] = float(np.mean(_codes(a) == _codes(b)))
            if "precond" not in k:
                np.testing.assert_array_equal(a, b, err_msg=k)
        elif "precond" in k or "stats" in k:
            tol = (1e-5 if "precond" in k else 1e-6) * np.abs(b).max(initial=0.0)
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                          b.reshape(-1).view(np.uint8), err_msg=k)
    factor_codes = {k: v for k, v in agreement.items() if "precond" in k}
    print(f"{name}: inverse-root code agreement with the reference {factor_codes}")
    assert all(v >= 0.99 for v in factor_codes.values()), factor_codes
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for k, p in tp.items():
        want = jflat[k].numpy()
        np.testing.assert_allclose(p.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)


# ---------------------------------------------------------------------------
# state representation and memory
# ---------------------------------------------------------------------------


def test_4bit_factors_are_quantized_and_placeholders_stay_raw():
    params = {"w": torch.zeros((256, 512)), "b": torch.zeros((8192,))}
    s = _inner(make_optimizer("shampoo4bit", 1e-3).init(params))
    for field in FACTORS:
        leaf = getattr(s, field)["w"]
        assert isinstance(leaf, QuantizedTensor), field
        assert leaf.config == FACTOR_4BIT
        assert not isinstance(getattr(s, field)["b"], QuantizedTensor)
        assert tuple(getattr(s, field)["b"].shape) == (0,)
    assert s.m["w"].config.normalization == "blockwise"
    assert s.v["w"].config.normalization == "rank1"
    assert isinstance(s.m["b"], QuantizedTensor)  # 8192 > threshold


def _factor_bytes(state):
    inner = _inner(state)
    return sum(state_nbytes(getattr(inner, f)) for f in FACTORS)


def test_factor_bytes_cut_at_least_4x():
    params = {"w": torch.zeros((256, 512)), "w2": torch.zeros((512, 384))}
    b4 = _factor_bytes(make_optimizer("shampoo4bit", 1e-3).init(params))
    b32 = _factor_bytes(make_optimizer("shampoo32", 1e-3).init(params))
    assert b32 > 0 and b4 * 4 <= b32
    meta = {k: v.to("meta") for k, v in params.items()}
    assert _factor_bytes(make_optimizer("shampoo4bit", 1e-3).init(meta)) == b4


def test_gpt2m_factor_bytes():
    """The GPT-2-M tree of the memory tables (``BENCH_drift.json``)."""
    cfg = ModelConfig(name="gpt2m-like", num_layers=24, d_model=1024, num_heads=16,
                      num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=50257,
                      blocks=(LayerSpec("dense", 0),) * 24, gated_mlp=False)
    params = named_params(init_model(cfg, device="meta"))
    assert _factor_bytes(make_optimizer("shampoo4bit", 1e-3).init(params)) == 901_047_872
    assert _factor_bytes(make_optimizer("shampoo32", 1e-3).init(params)) == 6_784_360_448


# ---------------------------------------------------------------------------
# the kernel-route contract
# ---------------------------------------------------------------------------


def test_graft_moments_keep_kernel_eligible_layout_but_no_route_attached():
    params = {"w": torch.zeros((32, 512))}
    opt = make_optimizer("shampoo4bit", 1e-3)
    state = opt.init(params)
    inner = _inner(state)
    assert FusedAdamWRoute(lr=1e-3).eligible({"m": inner.m["w"], "v": inner.v["w"]},
                                             params["w"])
    new_params, _ = opt.update({"w": torch.full((32, 512), 0.01)}, state,
                               {"w": params["w"].clone()})
    assert not isinstance(new_params["w"], Replace)
    assert bool(torch.all(torch.isfinite(new_params["w"])))
    assert not torch.allclose(new_params["w"], params["w"])


def test_shampoo_registered_in_optimizer_specs():
    names = optimizer_names()
    assert "shampoo32" in names and "shampoo4bit" in names
    opt = make_optimizer("shampoo4bit", 1e-3, stochastic_rounding=True)
    params = _params((16, 512))
    state = opt.init(params)
    p2, _ = opt.update({"w": torch.ones(16, 512)}, state, params, key=sr.PRNGKey(0))
    assert bool(torch.all(torch.isfinite(p2["w"])))


@pytest.mark.parametrize("threads", [1, 3, 4])
def test_host_eigh_equals_one_thread_lapack_matrix_for_matrix(threads):
    """``host_eigh`` (where a batch on the card is decomposed) equals
    ``torch.linalg.eigh`` on one thread bit for bit, at any thread count, and
    restores the process's thread count."""
    from repro_torch.core.optimizers.transform import host_eigh

    g = torch.Generator().manual_seed(5)
    x = torch.randn(37, 128, 128, generator=g)
    a = x @ x.transpose(-1, -2) / 128
    want_w, want_u = torch.linalg.eigh(a)  # the module runs on one thread
    torch.set_num_threads(threads)
    try:
        w, u = host_eigh(a)
        assert torch.get_num_threads() == threads
    finally:
        torch.set_num_threads(1)
    assert torch.equal(w, want_w) and torch.equal(u, want_u)
    w0, u0 = host_eigh(a[:0])
    assert w0.shape == (0, 128) and u0.shape == (0, 128, 128)

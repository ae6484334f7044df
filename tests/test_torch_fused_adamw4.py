"""The port's fused 4-bit AdamW step against the JAX reference.

On the CPU the port's wrapper runs its plain version; it is held against
``ref.fused_adamw4_reference``/``_sr_reference``, against the reference's
leaf entry ``ops.fused_adamw4_leaf`` (prepass, slice stats, seed rows) on
3-d and 4-d leaves, and against one tiny Pallas ``fused_adamw4`` run in
interpret mode. Codes and scales must be bit-equal and params within 1e-6
relative. The CUDA kernel itself is held against the plain version in
``test_torch_cuda.py``, which needs a card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import quantizer as jq  # noqa: E402
from repro.core.optimizers.adamw import M_4BIT, V_4BIT  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.adamw4bit import fused_adamw4 as pallas_fused_adamw4  # noqa: E402
from repro_torch.core import quantizer as tq  # noqa: E402
from repro_torch.kernels import adamw4bit as tk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sr as tsr  # noqa: E402

torch.set_num_threads(1)

HP = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
LR, BC1, BC2 = np.float32(1e-3), np.float32(0.19), np.float32(0.001999)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tq(j: jq.QuantizedTensor, cfg) -> tq.QuantizedTensor:
    return tq.QuantizedTensor(_t(j.codes), tuple(_t(s) for s in j.scales), j.shape, cfg)


def _tcfg(jcfg):
    return tq.QuantConfig(**dataclasses.asdict(jcfg))


def _states(shape, seed, sr=False):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    g = (rng.normal(size=shape) * 0.1).astype(np.float32)
    m0 = (rng.normal(size=shape) * 0.01).astype(np.float32)
    v0 = (np.abs(rng.normal(size=shape)) * 1e-3 + 1e-10).astype(np.float32)
    mc = dataclasses.replace(M_4BIT, stochastic_rounding=sr)
    vc = dataclasses.replace(V_4BIT, stochastic_rounding=sr)
    return w, g, jq.quantize(jnp.asarray(m0), mc), jq.quantize(jnp.asarray(v0), vc), mc, vc


def _assert_bits(t, j, what):
    t = t.numpy()
    j = np.asarray(j)
    if t.dtype == np.float32:
        t, j = t.view(np.uint32), j.view(np.uint32)
    np.testing.assert_array_equal(t, j, err_msg=what)


def _assert_w(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("use_sr", [False, True])
def test_plain_matches_reference_2d(use_sr):
    R, C = 64, 512
    w, g, m_q, v_q, _, _ = _states((R, C), seed=1)
    mt = jq.QuantConfig(**dataclasses.asdict(M_4BIT)).table()
    vt = jq.QuantConfig(**dataclasses.asdict(V_4BIT)).table()
    m_scale = m_q.scales[0].reshape(R, C // 128)
    args_j = (jnp.asarray(w), jnp.asarray(g), m_q.codes, m_scale, v_q.codes,
              v_q.scales[0], v_q.scales[1], mt, vt, jnp.float32(LR),
              HP["b1"], HP["b2"], HP["eps"], HP["weight_decay"], jnp.float32(BC1), jnp.float32(BC2))
    seed = np.array([0x1234567, 0x89ABCDEF], dtype=np.uint32)
    if use_sr:
        out_j = jref.fused_adamw4_sr_reference(*args_j, jnp.asarray(seed))
    else:
        out_j = jref.fused_adamw4_reference(*args_j)
    # the port's wrapper on CPU tensors takes its plain version
    out_t = tk.fused_adamw4(
        _t(w), _t(g), _t(m_q.codes), _t(m_scale), _t(v_q.codes),
        _t(v_q.scales[0]), _t(v_q.scales[1]), _t(out_j[4]), _t(out_j[5]),
        _t(mt), _t(vt), LR, BC1, BC2,
        torch.from_numpy(seed.astype(np.int64)) if use_sr else None,
        use_sr=use_sr, **HP,
    )
    _assert_w(out_t[0], out_j[0])
    for i, what in ((1, "m codes"), (2, "m scales"), (3, "v codes")):
        _assert_bits(out_t[i], out_j[i], what)
    assert tk.LAUNCHES["fused_adamw4"] == 0  # the plain version is no launch


@pytest.mark.parametrize("use_sr", [False, True])
@pytest.mark.parametrize("shape", [(3, 64, 256), (2, 3, 16, 512)])
def test_leaf_matches_reference_ops(shape, use_sr):
    w, g, m_q, v_q, mc, vc = _states(shape, seed=7, sr=use_sr)
    jkey = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    w_j, m_j, v_j = jops.fused_adamw4_leaf(
        jnp.asarray(w), jnp.asarray(g), m_q, v_q, jnp.float32(LR),
        HP["b1"], HP["b2"], HP["eps"], HP["weight_decay"], jnp.float32(BC1), jnp.float32(BC2),
        key=jkey if use_sr else None,
    )
    p = _t(w)
    w_t, m_t, v_t = tops.fused_adamw4_leaf(
        p, _t(g), _tq(m_q, _tcfg(mc)), _tq(v_q, _tcfg(vc)), LR,
        HP["b1"], HP["b2"], HP["eps"], HP["weight_decay"], BC1, BC2,
        key=tsr.fold_in(tsr.PRNGKey(11), 4) if use_sr else None,
    )
    assert w_t is p  # updated in place
    _assert_w(w_t, w_j)
    _assert_bits(m_t.codes, m_j.codes, "m codes")
    _assert_bits(m_t.scales[0], m_j.scales[0], "m scales")
    _assert_bits(v_t.codes, v_j.codes, "v codes")
    assert len(v_t.scales) == len(shape)
    for a, b in zip(v_t.scales, v_j.scales):
        _assert_bits(a, b, "v stats")


@pytest.mark.parametrize("use_sr", [False, True])
def test_plain_matches_pallas_interpret(use_sr):
    """One tiny 3-d-grid Pallas launch in interpret mode (both tile rows)."""
    L, R, C = 2, 16, 256
    w, g, m_q, v_q, _, _ = _states((L * R, C), seed=3)
    w, g = w.reshape(L, R, C), g.reshape(L, R, C)
    mt = jq.QuantConfig(**dataclasses.asdict(M_4BIT)).table()
    vt = jq.QuantConfig(**dataclasses.asdict(V_4BIT)).table()
    m_packed = m_q.codes.reshape(L, R, C // 2)
    m_scale = m_q.scales[0].reshape(L, R, C // 128)
    v_packed = v_q.codes.reshape(L, R, C // 2)
    v_r = jnp.stack([v_q.scales[0][:R], v_q.scales[0][R:]])
    v_c = v_q.scales[1]
    rng = np.random.default_rng(5)
    v_rn = (np.abs(rng.normal(size=(L, R))) * 1e-3).astype(np.float32)
    v_cn = (np.abs(rng.normal(size=(C,))) * 1e-3).astype(np.float32)
    seeds = np.array([[1, 2], [0xDEADBEEF, 7]], dtype=np.uint32)
    out_j = pallas_fused_adamw4(
        jnp.asarray(w), jnp.asarray(g), m_packed, m_scale, v_packed, v_r, v_c,
        jnp.asarray(v_rn), jnp.asarray(v_cn), mt, vt, jnp.float32(LR),
        jnp.float32(BC1), jnp.float32(BC2), jnp.asarray(seeds) if use_sr else None,
        interpret=True, use_sr=use_sr, tile_r=8, tile_c=256, **HP,
    )
    out_t = tk.fused_adamw4(
        _t(w), _t(g), _t(m_packed), _t(m_scale), _t(v_packed), _t(v_r), _t(v_c),
        _t(v_rn), _t(v_cn), _t(mt), _t(vt), LR, BC1, BC2,
        torch.from_numpy(seeds.astype(np.int64)) if use_sr else None,
        use_sr=use_sr, **HP,
    )
    # The Pallas body rounds (1 - b1) in fp32 from an fp32 b1 where the
    # reference's oracle (and so the port) rounds the double difference, so
    # m differs by a few ulps: scales are held to 1e-6 relative (the
    # reference's own kernel-vs-oracle tolerance) and a code at a midpoint
    # may move, by one bin at most.
    _assert_w(out_t[0], out_j[0])
    np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]), rtol=1e-6)
    for i in (1, 3):
        ct = tref.unpack_codes(out_t[i]).numpy().astype(int)
        cj = tref.unpack_codes(_t(out_j[i])).numpy().astype(int)
        frac = float(np.mean(ct != cj))
        print(f"pallas-interpret code mismatch fraction [{i}]: {frac:.6f}")
        assert np.max(np.abs(ct - cj)) <= 1 and frac <= 1e-3, frac

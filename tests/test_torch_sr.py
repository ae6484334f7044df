"""Parity of the port's key stream and Threefry with JAX (bit for bit)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import sr as jsr  # noqa: E402
from repro_torch.kernels import sr as tsr  # noqa: E402

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 123456789, 2**31 - 1]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _words(k):
    d = np.asarray(jax.random.key_data(k) if jnp.issubdtype(k.dtype, jax.dtypes.prng_key) else k)
    return tuple(int(w) for w in d.astype(np.uint32).reshape(-1)[-2:])


def test_threefry_matches_reference():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, size=(2,), dtype=np.uint64)
    c0 = rng.integers(0, 2**32, size=(257,), dtype=np.uint64)
    c1 = rng.integers(0, 2**32, size=(257,), dtype=np.uint64)
    j0, j1 = jsr.threefry2x32(
        jnp.uint32(k[0]), jnp.uint32(k[1]),
        jnp.asarray(c0.astype(np.uint32)), jnp.asarray(c1.astype(np.uint32)),
    )
    t0, t1 = tsr.threefry2x32(
        int(k[0]), int(k[1]),
        torch.from_numpy(c0.astype(np.int64)), torch.from_numpy(c1.astype(np.int64)),
    )
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_recipe_matches_jax(seed):
    jk = _jkey(seed)
    tk = tsr.PRNGKey(seed)
    assert tk == _words(jk)
    for d in (0, 1, 5, 2**31 + 3):
        assert tsr.fold_in(tk, d) == _words(jax.random.fold_in(jk, d))
    js = jax.random.split(jk, 3)
    assert tsr.split(tk, 3) == tuple(_words(js[i]) for i in range(3))
    shape = (3, 37)
    np.testing.assert_array_equal(
        tsr.bits(tk, shape, "cpu").numpy(),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64),
    )
    np.testing.assert_array_equal(
        tsr.uniform(tk, shape, "cpu").numpy().view(np.uint32),
        np.asarray(jax.random.uniform(jk, shape)).view(np.uint32),
    )


@pytest.mark.parametrize("stream", [tsr.STREAM_M, tsr.STREAM_V])
def test_element_and_tensor_uniforms_match(stream):
    k0, k1 = 0x12345678, 0x9ABCDEF0
    ju = jsr.element_uniforms(jnp.uint32(k0), jnp.uint32(k1), (8, 256), stream)
    tu = tsr.element_uniforms(k0, k1, (8, 256), stream, "cpu")
    np.testing.assert_array_equal(tu.numpy().view(np.uint32), np.asarray(ju).view(np.uint32))
    jk = jax.random.fold_in(_jkey(3), 11)
    jt = jsr.tensor_uniforms(jk, (2, 3, 64), stream)
    tt = tsr.tensor_uniforms(tsr.fold_in(tsr.PRNGKey(3), 11), (2, 3, 64), stream, "cpu")
    np.testing.assert_array_equal(tt.numpy().view(np.uint32), np.asarray(jt).view(np.uint32))
    assert tsr.STREAM_GRAD == jsr.STREAM_GRAD and tsr.STREAM_SAMPLE == jsr.STREAM_SAMPLE

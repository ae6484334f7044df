"""Parity of the port's quantization core with the JAX reference.

Tables must be bit-identical for every registered map x bits x signedness;
``quantize`` codes and scales bit-equal for round-to-nearest, for SR from
given uniforms and for SR from a key; packing low nibble first.

The tables are held in ``tests/test_torch_quant_tables.py``
(pytest-xdist's ``--dist loadfile`` hands out the files with the most
tests first).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import mappings as jmap  # noqa: E402
from repro.core import packing as jpack  # noqa: E402
from repro.core import quantizer as jq  # noqa: E402
from repro.kernels import sr as jsr  # noqa: E402
from repro_torch.core import mappings as tmap  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import quantizer as tq  # noqa: E402
from repro_torch.kernels import sr as tsr  # noqa: E402

torch.set_num_threads(1)


BUILTIN_MAPS = ("linear", "de", "de0", "dynamic", "quantile", "log-ema")


def test_registry_names_match():
    # other test files register extra maps in the reference's registry in
    # the same process, so compare the built-in prefix
    assert tmap.registered() == BUILTIN_MAPS
    assert jmap.registered()[: len(BUILTIN_MAPS)] == BUILTIN_MAPS


def test_pack_roundtrip_matches():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, size=(3, 5, 9), dtype=np.uint8)
    jp = np.asarray(jpack.pack4(jnp.asarray(codes)))
    tp = tpack.pack4(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tpack.unpack4(torch.from_numpy(tp), 9).numpy(), codes)


CONFIGS = {
    "B128/DE": dict(bits=4, normalization="blockwise", block_size=128, mapping="de", signed=True),
    "Rank-1/Linear": dict(bits=4, normalization="rank1", mapping="linear", signed=False),
    "B2048/DE8": dict(bits=8, normalization="blockwise", block_size=2048, mapping="de", signed=True),
    "PerTensor/DE0": dict(bits=4, normalization="pertensor", mapping="de0", signed=False),
}
SHAPES = [(300,), (16, 256), (3, 4, 130)]


def _input(shape, signed, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 1e-3
    if not signed:
        x = np.abs(x) + 1e-9
    x.reshape(-1)[:7] = 0.0  # exact zeros exercise the guards
    return x


def _assert_q_equal(tq_, jq_):
    np.testing.assert_array_equal(tq_.codes.numpy(), np.asarray(jq_.codes))
    assert len(tq_.scales) == len(jq_.scales)
    for ts, js in zip(tq_.scales, jq_.scales):
        np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    assert tq_.nbytes() == jq_.nbytes() == tq.state_bytes(tq_) == jq.state_bytes(jq_)


@pytest.mark.parametrize("mode", ["rtn", "sr_uniforms", "sr_key"])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_quantize_bit_equal(cfg_name, mode):
    kw = CONFIGS[cfg_name]
    sr = mode != "rtn"
    jc = jq.QuantConfig(**kw, stochastic_rounding=sr)
    tc = tq.QuantConfig(**kw, stochastic_rounding=sr)
    for i, shape in enumerate(SHAPES):
        x = _input(shape, kw["signed"], seed=i)
        if mode == "rtn":
            j = jq.quantize(jnp.asarray(x), jc)
            t = tq.quantize(torch.from_numpy(x), tc)
        elif mode == "sr_uniforms":
            u = np.random.default_rng(10 + i).random(shape, dtype=np.float32)
            j = jq.quantize(jnp.asarray(x), jc, uniforms=jnp.asarray(u))
            t = tq.quantize(torch.from_numpy(x), tc, uniforms=torch.from_numpy(u))
        else:
            import jax

            jk = jax.random.fold_in(jax.random.PRNGKey(5), i)
            j = jq.quantize(jnp.asarray(x), jc, key=jk)
            t = tq.quantize(torch.from_numpy(x), tc, key=tsr.fold_in(tsr.PRNGKey(5), i))
        _assert_q_equal(t, j)
        assert tq.quantized_nbytes(shape, tc) == jq.quantized_nbytes(shape, jc)
        np.testing.assert_array_equal(
            tq.dequantize(t).numpy(), np.asarray(jq.dequantize(j))
        )


def test_sr_comms_stream_matches():
    """SR from counter-based uniforms (the comms/grad stream)."""
    import jax

    kw = CONFIGS["B128/DE"]
    jc = jq.QuantConfig(**kw, stochastic_rounding=True)
    tc = dataclasses.replace(tq.QuantConfig(**kw), stochastic_rounding=True)
    x = _input((4, 512), True, seed=9)
    jk = jax.random.PRNGKey(17)
    ju = jsr.tensor_uniforms(jk, x.shape, jsr.STREAM_GRAD)
    tu = tsr.tensor_uniforms(tsr.PRNGKey(17), x.shape, tsr.STREAM_GRAD, "cpu")
    _assert_q_equal(
        tq.quantize(torch.from_numpy(x), tc, uniforms=tu),
        jq.quantize(jnp.asarray(x), jc, uniforms=ju),
    )

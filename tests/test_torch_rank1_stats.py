"""Pass 1 of the port's fused 4-bit AdamW step, the rank-1 stats of the
updated second moment, against the JAX reference's prepass.

The reference computes ``_rank1_new_stats(b2 * v_old + (1 - b2) * g * g)``
inside ``repro.kernels.ops.fused_adamw4_leaf``; it runs eagerly here, as the
other bit-equality tests run it. The port's plain version
(``adamw4bit.rank1_new_stats_plain``, what the CPU takes) must be bit-equal
to it, and so must the per-dim stats that the CUDA wrapper derives from the
kernel's (L, R) row and (C,) column maxima (``adamw4bit._dim_stats``). The
kernel itself is held against the plain version in ``test_torch_cuda.py``,
which needs a card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantizer as jq  # noqa: E402
from repro.core.optimizers.adamw import V_4BIT  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import quantizer as tq  # noqa: E402
from repro_torch.kernels import adamw4bit as tk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(1)

B2 = 0.999
SHAPES = [(64, 256), (3, 64, 256), (2, 3, 16, 512)]
V_4BIT_T = tq.QuantConfig(**dataclasses.asdict(V_4BIT))


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaf(shape, seed):
    """A leaf's gradient and 4-bit rank-1 v from a numpy seed, both sides."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=shape) * 0.1).astype(np.float32)
    v0 = (np.abs(rng.normal(size=shape)) * 1e-3 + 1e-10).astype(np.float32)
    v0[..., 0, :] = 0.0  # an all-zero row: guarded stats
    v_j = jq.quantize(jnp.asarray(v0), V_4BIT)
    v_t = tq.QuantizedTensor(_t(v_j.codes), tuple(_t(s) for s in v_j.scales), v_j.shape,
                             V_4BIT_T)
    return g, v_j, v_t


def _reference_stats(g, v_j, shape):
    """The reference's prepass, eagerly: dequant, b2*v + (1-b2)*g*g, maxima."""
    R, C = shape[-2], shape[-1]
    L = int(np.prod(shape)) // (R * C)
    g3 = jnp.asarray(g).reshape(L, R, C)
    v_r, v_c = jops._rank1_slice_stats(v_j.scales, shape)
    table = jq.QuantConfig(**dataclasses.asdict(V_4BIT)).table()
    v_old = jnp.stack([jref.dequant_rank1(v_j.codes.reshape(L, R, C // 2)[i], v_r[i], v_c, table)
                       for i in range(L)])
    return jops._rank1_new_stats((B2 * v_old + (1.0 - B2) * g3 * g3).reshape(shape))


def _port_operands(g, v_t, shape):
    R, C = shape[-2], shape[-1]
    L = int(np.prod(shape)) // (R * C)
    v_r, v_c = tops._rank1_slice_stats(v_t.scales, shape)
    return (v_t.codes.reshape(L, R, C // 2), v_r.contiguous(), v_c.contiguous(),
            _t(g).reshape(L, R, C), V_4BIT_T.table("cpu"))


def _assert_bits(t, j, what):
    np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j).view(np.uint32),
                                  err_msg=what)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_stats_match_reference_prepass(shape):
    g, v_j, v_t = _leaf(shape, seed=sum(shape))
    want = _reference_stats(g, v_j, shape)
    got = tk.rank1_new_stats_plain(*_port_operands(g, v_t, shape), B2, shape)
    assert len(got) == len(shape)
    for d, (a, b) in enumerate(zip(got, want)):
        assert tuple(a.shape) == (shape[d],)
        _assert_bits(a, b, f"dim {d}")


@pytest.mark.parametrize("shape", SHAPES)
def test_dim_stats_from_row_and_col_maxima(shape):
    """The CUDA wrapper's layout: per-dim stats from the kernel's (L, R) row
    and (C,) column maxima equal the per-dim stats of the whole v_new."""
    g, v_j, v_t = _leaf(shape, seed=3 + sum(shape))
    want = _reference_stats(g, v_j, shape)
    v_packed, v_r, v_c, g3, table = _port_operands(g, v_t, shape)
    v_new = tref.dequant_rank1(v_packed, v_r, v_c, table) * B2 + (g3 * (1.0 - B2)) * g3
    got = tk._dim_stats(torch.amax(v_new, dim=-1), torch.amax(v_new, dim=(0, 1)), shape)
    for d, (a, b) in enumerate(zip(got, want)):
        _assert_bits(a, b, f"dim {d}")


def test_cpu_wrapper_takes_the_plain_version():
    shape = (3, 64, 256)
    g, _, v_t = _leaf(shape, seed=5)
    ops_ = _port_operands(g, v_t, shape)
    before = dict(tk.LAUNCHES)
    got = tk.rank1_new_stats(*ops_, B2, shape)
    want = tk.rank1_new_stats_plain(*ops_, B2, shape)
    assert tk.LAUNCHES == before  # the CPU never launches a kernel
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="device"):
        tk.rank1_new_stats(*(x.to("meta") for x in ops_[:4]), ops_[4], B2, shape)

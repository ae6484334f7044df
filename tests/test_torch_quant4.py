"""The port's block-wise 4-bit quantize / dequantize against the JAX reference.

On the CPU the wrappers of ``repro_torch.kernels.quant4`` take their plain
versions (``ref.quant_blockwise`` / ``ref.dequant_blockwise``); these are
held bit for bit against the reference's oracle, its Pallas kernels in
interpret mode and ``core.quantizer.quantize(x, WEIGHT_Q4)`` (the q4
serving format): codes equal, scales equal, dequantized values equal. The
CUDA kernels are held against the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The non-finite and subnormal blocks and the refused shapes are in
``tests/test_torch_quant4_edges.py`` (pytest-xdist's ``--dist loadfile``
hands out the files with the most tests first).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.mappings import mapping_table as j_table  # noqa: E402
from repro.core.quantizer import quantize as j_quantize  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.quant4 import dequantize_blockwise_4bit as j_dequant_kernel  # noqa: E402
from repro.kernels.quant4 import quantize_blockwise_4bit as j_quant_kernel  # noqa: E402
from repro.serve.weights import WEIGHT_Q4 as J_WEIGHT_Q4  # noqa: E402
from repro_torch.core.mappings import mapping_table  # noqa: E402
from repro_torch.kernels import quant4, ref  # noqa: E402

torch.set_num_threads(1)

J_TABLE = j_table("de", 4, signed=True)
TABLE = mapping_table("de", 4, True, "cpu")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _check_against_reference(x_np, x_torch, interpret=True):
    """Port (wrapper on the CPU) vs the reference's oracle, its interpret-mode
    kernels (which need C % 256 == 0) and ``quantize(x, WEIGHT_Q4)``, on an
    (R, C) input."""
    before = dict(quant4.LAUNCHES)
    pt, st = quant4.quantize_blockwise_4bit(x_torch, TABLE)
    x32 = jnp.asarray(x_np, jnp.float32)
    pj, sj = j_ref.quant_blockwise(x32, J_TABLE)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    q = j_quantize(x32, J_WEIGHT_Q4)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(q.codes))
    np.testing.assert_array_equal(st.numpy().reshape(-1), np.asarray(q.scales[0]))

    xt = quant4.dequantize_blockwise_4bit(pt, st, TABLE)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(j_ref.dequant_blockwise(pj, sj, J_TABLE)))
    if interpret:
        pk, sk = j_quant_kernel(jnp.asarray(x_np), J_TABLE, interpret=True)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pk))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sk))
        np.testing.assert_array_equal(
            xt.numpy(), np.asarray(j_dequant_kernel(pk, sk, J_TABLE, interpret=True)))
    assert quant4.LAUNCHES == before  # the CPU never launches a kernel
    return pt, st


@pytest.mark.parametrize("shape", [(128, 512), (256, 256), (8, 1024), (128, 768)])
@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e3])
def test_quant_blockwise_matches_reference(shape, scale):
    x = _rand(shape, shape[0] + shape[1], scale)
    _check_against_reference(x, torch.from_numpy(x))


def test_quant_blockwise_bf16_input():
    xb = torch.from_numpy(_rand((128, 512), 7)).to(torch.bfloat16)
    x_np = xb.to(torch.float32).numpy()  # the bf16 values, exactly
    _check_against_reference(jnp.asarray(x_np).astype(jnp.bfloat16), xb)
    pt, st = quant4.quantize_blockwise_4bit(xb, TABLE)
    p32, s32 = quant4.quantize_blockwise_4bit(torch.from_numpy(x_np), TABLE)
    assert torch.equal(pt, p32) and torch.equal(st, s32)


def test_quant_blockwise_zero_block_is_guarded():
    x = _rand((4, 512), 3)
    x[1, 128:256] = 0.0   # one all-zero block
    x[3, :] = 0.0         # a whole row of them
    pt, st = _check_against_reference(x, torch.from_numpy(x))
    assert float(st[1, 1]) == 1.0 and torch.all(st[3] == 1.0)
    zero_code = int(np.argmin(np.abs(np.asarray(J_TABLE))))
    assert torch.all(pt[3] == zero_code | (zero_code << 4))
    back = quant4.dequantize_blockwise_4bit(pt, st, TABLE)
    assert torch.all(back[3] == 0.0) and torch.all(back[1, 128:256] == 0.0)


def test_quant_blockwise_4d_leaf():
    """A stacked 4-d leaf, as the q4 serving weights quantize ``wq``: the
    (R, C) view of the flat array gives ``quantize``'s layout exactly. (The
    TPU kernel cannot take C = 128, so only the oracle and ``quantize``.)"""
    shape = (2, 64, 4, 128)
    x = _rand(shape, 11, 0.02)
    pt, st = _check_against_reference(x.reshape(-1, 128), torch.from_numpy(x).reshape(-1, 128),
                                      interpret=False)
    q = j_quantize(jnp.asarray(x), J_WEIGHT_Q4)
    np.testing.assert_array_equal(pt.reshape(2, 64, 4, 64).numpy(), np.asarray(q.codes))
    np.testing.assert_array_equal(st.reshape(-1).numpy(), np.asarray(q.scales[0]))


def test_plain_oracle_broadcasts_over_leading_dims():
    x = torch.from_numpy(_rand((3, 8, 256), 5))
    p, s = ref.quant_blockwise(x, TABLE)
    p2, s2 = ref.quant_blockwise(x.reshape(24, 256), TABLE)
    assert torch.equal(p.reshape(24, 128), p2) and torch.equal(s.reshape(24, 2), s2)


# Block kinds that leave the kernels' fast division: each goes into one block
# of an otherwise normal (4, 256) input (flat block 3).
NONFINITE_BLOCKS = ("nan", "+inf", "-inf", "nan and inf", "-0 only", "zeros",
                    "denormal elements", "scale above 2^60")


def _special_block(kind):
    b = _rand((128,), 17)
    if kind == "nan":
        b[5] = np.nan
    elif kind == "+inf":
        b[9] = np.inf
    elif kind == "-inf":
        b[9] = -np.inf
    elif kind == "nan and inf":
        b[5], b[9], b[77] = np.nan, np.inf, -np.inf
    elif kind == "-0 only":
        b[:] = -0.0
    elif kind == "zeros":
        b[:] = 0.0
    elif kind == "denormal elements":
        b[::7] = np.float32(1e-40) * np.sign(b[::7])
    elif kind == "scale above 2^60":
        b[3], b[40] = np.float32(3.0 * 2.0**61), np.float32(-2.0**70)
    elif kind == "all subnormal":
        b *= np.float32(1e-40)
    else:
        raise ValueError(kind)
    return b.astype(np.float32)


def test_count_guard_refuses_blocks_past_32_bits():
    """The wrappers refuse, before any launch, an element count whose B128
    blocks do not fit the kernels' 32-bit counts (``csrc/quant4.cu``'s
    kMaxBlocks); the largest count that fits passes. A q4 leaf of 5 G
    elements (phi3.5's expert stack at 12 layers) is 39 M blocks."""
    quant4._check_count("quantize_blockwise_4bit", quant4.MAX_BLOCKS * 128)
    quant4._check_count("dequantize_blockwise_4bit", 12 * 16 * 4096 * 6400)
    for name in ("quantize_blockwise_4bit", "dequantize_blockwise_4bit"):
        with pytest.raises(ValueError, match="at most"):
            quant4._check_count(name, (quant4.MAX_BLOCKS + 1) * 128)
    assert quant4.MAX_BLOCKS == 2 ** 31 - 1
    assert "kMaxBlocks = (1LL << 31) - 1" in quant4.SOURCE.read_text()

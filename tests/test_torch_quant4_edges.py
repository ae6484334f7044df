"""B2's edges against the reference: blocks with non-finite or all
subnormal values, and the shapes the kernel's wrapper refuses
(``tests/test_torch_quant4.py``'s helpers; see its docstring)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import numpy as np  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.quant4 import quantize_blockwise_4bit as j_quant_kernel  # noqa: E402
from repro_torch.kernels import quant4, ref  # noqa: E402
from test_torch_quant4 import (  # noqa: E402
    _check_against_reference,
    _rand,
    _special_block,
    J_TABLE,
    NONFINITE_BLOCKS,
    TABLE,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(4, 100), (3,), (2, 2, 128)])
def test_wrapper_rejects_shapes_the_kernel_cannot_take(shape):
    with pytest.raises(ValueError, match=r"shape"):
        quant4.quantize_blockwise_4bit(torch.zeros(shape), TABLE)


@pytest.mark.parametrize("kind", NONFINITE_BLOCKS)
def test_quant_blockwise_nonfinite_blocks_match_reference(kind):
    """NaN, infinities, signed zeros, subnormal elements and a huge scale: the
    port's codes and scales equal the reference's oracle, its interpret-mode
    kernel and ``quantize(x, WEIGHT_Q4)`` (a NaN scale would count as equal
    to a NaN, but the guard leaves none)."""
    x = _rand((4, 256), 23)
    x[1, 128:] = _special_block(kind)
    pt, st = _check_against_reference(x, torch.from_numpy(x))
    want = {"nan": 1.0, "+inf": np.inf, "-inf": np.inf, "nan and inf": 1.0, "-0 only": 1.0,
            "zeros": 1.0, "scale above 2^60": 2.0**70}.get(kind)
    if want is not None:
        assert float(st[1, 1]) == want
    if "nan" in kind:  # NaN takes code 0, the rest of the block is divided by 1
        codes = ref.unpack_codes(pt)[1, 128:]
        assert int(codes[5]) == 0
        n = torch.from_numpy(np.nan_to_num(x[1, 128:], nan=0.0))
        expect = ref.encode_table(n, TABLE)
        expect[5] = 0
        assert torch.equal(codes, expect)


def test_quant_blockwise_all_subnormal_block_keeps_its_scale():
    """The one block kind where the port and the JAX reference differ, by a
    property of the reference: XLA's CPU backend (like the TPU) flushes
    subnormals to zero, so a block whose elements are all subnormal gets
    JAX's scale guard(0) = 1.0 and the zero code. The port keeps subnormals
    (its plain version here, its kernels with no -ftz on the card): its
    scale is the subnormal absmax and its codes are those of the exact
    quotient. Every other block agrees bit for bit."""
    x = _rand((4, 256), 23)
    x[1, 128:] = _special_block("all subnormal")
    absmax = np.float32(np.max(np.abs(x[1, 128:])))
    assert 0.0 < absmax < np.finfo(np.float32).tiny
    pt, st = quant4.quantize_blockwise_4bit(torch.from_numpy(x), TABLE)
    pj, sj = j_ref.quant_blockwise(jnp.asarray(x), J_TABLE)
    pk, sk = j_quant_kernel(jnp.asarray(x), J_TABLE, interpret=True)
    sj, sk, pj, pk = (np.asarray(a) for a in (sj, sk, pj, pk))
    assert float(st[1, 1]) == absmax
    assert sj[1, 1] == 1.0 and sk[1, 1] == 1.0
    mids = (np.asarray(J_TABLE[1:]) + np.asarray(J_TABLE[:-1])) / np.float32(2.0)
    n = x[1, 128:] / absmax  # numpy keeps subnormals: the correctly rounded quotient
    codes = (n[:, None] > mids[None, :]).sum(axis=1)
    assert np.array_equal(ref.unpack_codes(pt)[1, 128:].numpy(), codes)
    zero_code = int(np.argmin(np.abs(np.asarray(J_TABLE))))
    assert np.all(np.asarray(j_ref.unpack_codes(jnp.asarray(pj)))[1, 128:] == zero_code)
    others = np.ones(st.shape, dtype=bool)
    others[1, 1] = False
    assert np.array_equal(st.numpy()[others], sj[others])
    assert np.array_equal(st.numpy()[others], sk[others])
    code_others = np.ones(pt.shape, dtype=bool)
    code_others[1, 64:] = False
    assert np.array_equal(pt.numpy()[code_others], pj[code_others])
    assert np.array_equal(pt.numpy()[code_others], pk[code_others])

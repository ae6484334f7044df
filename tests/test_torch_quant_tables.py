"""The quantizer's code tables bit-identical to the reference's
(``tests/test_torch_quant.py``'s helpers; see its docstring)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import numpy as np  # noqa: E402
from repro.core import mappings as jmap  # noqa: E402
from repro_torch.core import mappings as tmap  # noqa: E402
from test_torch_quant import BUILTIN_MAPS  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("name", BUILTIN_MAPS)
def test_tables_bit_identical(name):
    for bits in (2, 3, 4, 8):
        for signed in (False, True):
            j = np.asarray(jmap.mapping_table(name, bits, signed))
            t = tmap.mapping_table(name, bits, signed, "cpu").numpy()
            np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))

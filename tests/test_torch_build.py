"""The port's kernel build helpers (``repro_torch.kernels.build``) on the CPU:
what names a library and what the kernels' host tables hold. Nothing here
compiles; nvcc runs only on the card's machine."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import adamw4bit, build, quant4  # noqa: E402


def test_library_name_follows_included_headers(tmp_path):
    (tmp_path / "sub").mkdir()
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint f() { return g(); }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "sub/b.cuh"\nint g();\n')
    (tmp_path / "sub" / "b.cuh").write_text("int h();\n")
    assert build._included_files(src) == [src, tmp_path / "a.cuh", tmp_path / "sub" / "b.cuh"]
    first = build._library_path(src)
    assert first.parent == build.BUILD_DIR and first.name.startswith("libk_")
    assert build._library_path(src) == first
    (tmp_path / "sub" / "b.cuh").write_text("int h(); // edited\n")
    second = build._library_path(src)
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "sub/b.cuh"\nint g(); \n')
    assert build._library_path(src) not in (first, second)


def test_port_sources_hash_the_shared_header():
    for source in (quant4.SOURCE, adamw4bit.SOURCE):
        assert build.CSRC / "common.cuh" in build._included_files(source)


def test_host_table_pads_nothing_and_refuses_unsorted():
    value, mid, points = build.host_table(torch.tensor([-1.0, -0.25, 0.0, 0.5, 1.0]))
    assert points == 5 and value.dtype == np.float32 and mid.dtype == np.float32
    np.testing.assert_array_equal(mid, np.array([-0.625, -0.125, 0.25, 0.75], np.float32))
    with pytest.raises(ValueError, match="sorted"):
        build.host_table(torch.tensor([0.0, 1.0, 0.5]))
    with pytest.raises(ValueError, match="points"):
        build.host_table(torch.zeros(17))

"""The roofline's counts against the reference's: parameter and model FLOP
counts of every family, the ring collectives' bytes, and the linear units'
exact extrapolation (``tests/test_torch_roofline.py``'s helpers; see its
docstring)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.roofline import analysis as j_analysis  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.models import init_model, named_params, param_axes, plan_scan_units  # noqa: E402
from repro_torch.models.layers import COMPUTE_DTYPE  # noqa: E402
from repro_torch.roofline import analysis, measured  # noqa: E402
from test_torch_roofline import _ref_shapes_and_axes, KINDS  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", KINDS)
def test_ring_bytes_equal_reference(kind):
    for k in (1, 2, 4, 8, 16):
        for r in (0.0, 1.0, 4096.0, 3.5e9):
            assert analysis._ring_bytes(kind, r, k) == j_analysis._ring_bytes(kind, r, k)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_count_params_and_model_flops_equal_reference(arch):
    ref_params, ref_axes = _ref_shapes_and_axes(arch)
    cfg = get_config(arch)
    params = named_params(init_model(cfg, device="meta"))
    axes = param_axes(cfg)
    assert analysis.count_params(params, axes) == j_analysis.count_params(ref_params, ref_axes)
    for kind, tokens in (("train", 256 * 4096), ("prefill", 32 * 32768), ("decode", 128)):
        got = analysis.model_flops(cfg, params, axes, kind, tokens)
        want = j_analysis.model_flops(j_get_config(arch), ref_params, ref_axes, kind, tokens)
        assert got == want, (arch, kind)


@pytest.mark.parametrize("train", [True, False])
def test_linear_unit_extrapolates_exactly(train):
    cfg = dataclasses.replace(reduced_config("xlstm-125m"), gla_chunk=8)
    S = 64
    s1 = measured._linear_probe_len(cfg, S)
    assert s1 == 8
    dtype = torch.float32 if train else COMPUTE_DTYPE
    for unit in plan_scan_units(cfg.blocks):
        assert measured._unit_is_linear(unit)
        probe = lambda n: measured._seq_probe(cfg, unit, "decoder", 2, n, None, train, dtype)
        ys, full = [probe(i * s1) for i in (2, 3, 4)], probe(S)
        got = measured._extrapolate(*ys, S // s1)
        assert (got.flops_by_dtype, got.bytes) == (full.flops_by_dtype, full.bytes), unit
        line = ys[0] + (ys[1] - ys[0]) * (S // s1 - 2)
        assert line.flops == full.flops  # the products are linear from the second chunk
        if train:  # each step's slice writes a whole-length gradient: bytes grow as S²
            assert line.bytes < full.bytes

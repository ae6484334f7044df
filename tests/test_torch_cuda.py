"""The fused 4-bit AdamW CUDA kernel against its plain torch version.

Needs an NVIDIA card (the kernel has no CPU mode), so every test here is
marked ``cuda`` and skips without one. It imports torch and the port only,
so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Codes and scales must be bit-equal; params equal to 1e-6 relative (both
sides round every operation alike, so they agree to the bit in practice).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.optimizers.adamw import M_4BIT, V_4BIT  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor, quantize  # noqa: E402
from repro_torch.kernels import adamw4bit, ops, sr  # noqa: E402

HP = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
LR, BC1, BC2 = np.float32(1e-3), np.float32(0.19), np.float32(0.001999)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernel has no CPU mode")
    return torch.device("cuda")


def _leaf(shape, seed, sr_on, w_dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(shape, generator=g).to(w_dtype)
    grad = torch.randn(shape, generator=g) * 0.1
    m0 = torch.randn(shape, generator=g) * 0.01
    v0 = torch.randn(shape, generator=g).abs() * 1e-3 + 1e-10
    mc = dataclasses.replace(M_4BIT, stochastic_rounding=sr_on)
    vc = dataclasses.replace(V_4BIT, stochastic_rounding=sr_on)
    return w, grad, quantize(m0, mc), quantize(v0, vc)


def _to(q: QuantizedTensor, dev):
    return QuantizedTensor(q.codes.to(dev), tuple(s.to(dev) for s in q.scales), q.shape, q.config)


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 128, 768), (2, 4, 64, 512)])
@pytest.mark.parametrize("use_sr", [False, True])
def test_kernel_matches_plain(cuda, use_sr, shape, w_dtype):
    w, grad, m_q, v_q = _leaf(shape, 21, use_sr, w_dtype)
    key = sr.PRNGKey(9) if use_sr else None
    outs = {}
    for dev in ("cpu", cuda):
        before = adamw4bit.LAUNCHES["fused_adamw4"]
        p = w.clone().to(dev)
        outs[str(dev)] = ops.fused_adamw4_leaf(
            p, grad.to(dev), _to(m_q, dev), _to(v_q, dev), LR,
            HP["b1"], HP["b2"], HP["eps"], HP["weight_decay"], BC1, BC2, key=key,
        )
        assert outs[str(dev)][0] is p
        assert adamw4bit.LAUNCHES["fused_adamw4"] - before == (1 if dev == cuda else 0)
    torch.cuda.synchronize()
    (wc, mcpu, vcpu), (wg, mg, vg) = outs["cpu"], outs["cuda"]
    assert torch.equal(mg.codes.cpu(), mcpu.codes)
    assert torch.equal(vg.codes.cpu(), vcpu.codes)
    assert torch.equal(mg.scales[0].cpu(), mcpu.scales[0])
    for a, b in zip(vg.scales, vcpu.scales):
        assert torch.equal(a.cpu(), b)
    torch.testing.assert_close(wg.cpu().float(), wc.float(), rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
def test_wrapper_rejects_bad_operands(cuda):
    w, grad, m_q, v_q = _leaf((2, 64, 256), 1, False)
    with pytest.raises(ValueError, match="contiguous"):
        adamw4bit.fused_adamw4(
            w.to(cuda), grad.to(cuda).transpose(1, 2).contiguous().transpose(1, 2),
            m_q.codes.to(cuda).reshape(2, 64, 128), m_q.scales[0].to(cuda).reshape(2, 64, 2),
            v_q.codes.to(cuda).reshape(2, 64, 128),
            torch.ones(2, 64, device=cuda), torch.ones(256, device=cuda),
            torch.ones(2, 64, device=cuda), torch.ones(256, device=cuda),
            M_4BIT.table("cpu"), V_4BIT.table("cpu"), LR, BC1, BC2, **HP,
        )

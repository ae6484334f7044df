"""The port's CUDA kernels against their plain torch versions: both passes
of the fused 4-bit AdamW step (the rank-1 stats pass and the update pass),
the block-wise 4-bit quantize / dequantize kernels and a short q4 serving
run; and the recurrences of the xLSTM and hymba blocks (``gla_chunked``,
``slstm_scan``, a reduced recurrent arch's training step and serving) on
the card against the same functions on the CPU.

Needs an NVIDIA card (the kernel has no CPU mode), so every test here is
marked ``cuda`` and skips without one. It imports torch and the port only,
so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Codes, scales and rank-1 stats must be bit-equal; params equal to 1e-6
relative (both sides round every operation alike, so they agree to the bit
in practice); dequantized weights bit-equal.
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


def _stats_operands(shape, seed, dev):
    _, grad, _, v_q = _leaf(shape, seed, False)
    R, C = shape[-2], shape[-1]
    L = grad.numel() // (R * C)
    v_r, v_c = ops._rank1_slice_stats(v_q.scales, shape)
    return (v_q.codes.reshape(L, R, C // 2).to(dev), v_r.contiguous().to(dev),
            v_c.contiguous().to(dev), grad.reshape(L, R, C).to(dev), V_4BIT.table("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 256), (3, 128, 768), (2, 4, 64, 512), (5, 37, 2304)])
def test_stats_kernel_matches_plain(cuda, shape):
    args = _stats_operands(shape, 31, cuda)
    before = adamw4bit.LAUNCHES["rank1_new_stats"]
    got = adamw4bit.rank1_new_stats(*args, HP["b2"], shape)
    assert adamw4bit.LAUNCHES["rank1_new_stats"] - before == 1
    want = adamw4bit.rank1_new_stats_plain(*args, HP["b2"], shape)
    cpu = adamw4bit.rank1_new_stats(*(a.cpu() for a in args), HP["b2"], shape)
    torch.cuda.synchronize()
    assert len(got) == len(shape)
    for a, b, c in zip(got, want, cpu):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), c)


@pytest.mark.cuda
@pytest.mark.parametrize("use_sr", [False, True])
@pytest.mark.parametrize("shape,w_dtype", [
    ((64, 256), torch.float32),           # a 2-d leaf: L == 1
    ((5, 37, 256), torch.bfloat16),       # C == 256, odd R: warps cross rows and slices
    ((1, 8192, 2304), torch.float32),     # R*C > 2^24: the counter's high bits
])
def test_update_kernel_edges(cuda, shape, w_dtype, use_sr):
    w, grad, m_q, v_q = _leaf(shape, 17, use_sr, w_dtype)
    operands, _ = ops.leaf_operands(w.to(cuda), grad.to(cuda), _to(m_q, cuda), _to(v_q, cuda),
                                    HP["b2"], sr.PRNGKey(3) if use_sr else None)
    scal = dict(lr=LR, bc1=BC1, bc2=BC2, **HP)
    k_out = adamw4bit.fused_adamw4(**operands, **scal)
    p_out = adamw4bit.fused_adamw4_plain(**operands, **scal)
    torch.cuda.synchronize()
    for a, b in zip(k_out[1:], p_out[1:]):
        assert torch.equal(a, b)
    assert torch.equal(k_out[0].reshape(p_out[0].shape), p_out[0])


@pytest.mark.cuda
@pytest.mark.parametrize("use_sr", [False, True])
def test_update_kernel_on_a_tile(cuda, use_sr):
    """A rank's tile (rows 3..40, columns 128..384 of slices 512 wide, C of
    the tile 128-aligned but not 256): the kernel with the tile's offsets
    equals the plain version with them, and both equal the whole leaf's
    update at the tile."""
    shape, (r0, r1), (c0, c1) = (3, 64, 512), (3, 40), (128, 384)
    w, grad, m_q, v_q = _leaf(shape, 29, use_sr)
    key = sr.PRNGKey(5) if use_sr else None
    whole, _ = ops.leaf_operands(w.to(cuda), grad.to(cuda), _to(m_q, cuda), _to(v_q, cuda),
                                 HP["b2"], key)
    scal = dict(lr=LR, bc1=BC1, bc2=BC2, **HP)
    w_out = adamw4bit.fused_adamw4(**whole, **scal)
    cut = lambda x, last: x[:, r0:r1, c0 // last:c1 // last].contiguous()
    tile = dict(whole, w=cut(whole["w"], 1), g=cut(whole["g"], 1),
                m_packed=cut(whole["m_packed"], 2), v_packed=cut(whole["v_packed"], 2),
                m_scale=cut(whole["m_scale"], 128), v_r=whole["v_r"][:, r0:r1].contiguous(),
                v_r_new=whole["v_r_new"][:, r0:r1].contiguous(),
                v_c=whole["v_c"][c0:c1].contiguous(), v_c_new=whole["v_c_new"][c0:c1].contiguous())
    k_out = adamw4bit.fused_adamw4(**tile, **scal, tile=(r0, c0, shape[-1]))
    p_out = adamw4bit.fused_adamw4_plain(**tile, **scal, tile=(r0, c0, shape[-1]))
    torch.cuda.synchronize()
    for a, b in zip(k_out, p_out):
        assert torch.equal(a, b)
    for a, b, last in zip(k_out, w_out, (1, 2, 128, 2)):
        assert torch.equal(a, cut(b, last))
    with pytest.raises(ValueError, match="does not place"):
        adamw4bit.fused_adamw4(**tile, **scal, tile=(r0, 64, shape[-1]))


@pytest.mark.cuda
@pytest.mark.parametrize("spike", [1e19, 0.0])
def test_sr_update_kernel_exact_fallback(cuda, spike):
    """SR blocks whose operands leave the branch-free arithmetic's range (a
    huge gradient, or a zero one with a zero moment) are redone exactly:
    still bit-equal to the plain version."""
    shape = (3, 64, 512)
    w, grad, m_q, v_q = _leaf(shape, 23, True)
    grad[1, 5, :256] = spike
    operands, _ = ops.leaf_operands(w.to(cuda), grad.to(cuda), _to(m_q, cuda), _to(v_q, cuda),
                                    HP["b2"], sr.PRNGKey(4))
    if spike == 0.0:
        operands["m_packed"][1, 5, :128] = 0  # code 0 and a zero scale: m = 0
        operands["m_scale"][1, 5, :2] = 0.0
    scal = dict(lr=LR, bc1=BC1, bc2=BC2, **HP)
    k_out = adamw4bit.fused_adamw4(**operands, **scal)
    p_out = adamw4bit.fused_adamw4_plain(**operands, **scal)
    torch.cuda.synchronize()
    for a, b in zip(k_out[1:], p_out[1:]):
        assert torch.equal(a, b)
    assert torch.equal(k_out[0], p_out[0])


@pytest.mark.cuda
def test_stats_wrapper_rejects_bad_operands(cuda):
    shape = (2, 64, 256)
    v_packed, v_r, v_c, g, table = _stats_operands(shape, 3, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        adamw4bit.rank1_new_stats(v_packed, v_r, v_c, g.transpose(1, 2).contiguous()
                                  .transpose(1, 2), table, HP["b2"], shape)
    with pytest.raises(TypeError):
        adamw4bit.rank1_new_stats(v_packed, v_r.double(), v_c, g, table, HP["b2"], shape)
    with pytest.raises(ValueError, match="multiple of 128"):
        adamw4bit.rank1_new_stats(v_packed.reshape(2, 256, 32), v_r, v_c, g.reshape(2, 256, 64),
                                  table, HP["b2"], (2, 256, 64))


# ---------------------------------------------------------------------------
# block-wise 4-bit quantize / dequantize kernels and the q4 serving path
# ---------------------------------------------------------------------------

from repro_torch.core.mappings import mapping_table  # noqa: E402
from repro_torch.kernels import quant4  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 512), (8, 128), (3, 92544), (1, 128 * 1000)])
def test_quant4_kernels_match_plain(cuda, shape, x_dtype):
    table = mapping_table("de", 4, True, "cpu")
    g = torch.Generator().manual_seed(shape[0] * 7 + shape[1])
    x = (torch.randn(shape, generator=g) * 0.02).to(x_dtype)
    x[0, :128] = 0.0  # a guarded all-zero block
    before = dict(quant4.LAUNCHES)
    pk, sk = quant4.quantize_blockwise_4bit(x.to(cuda), table)
    pp, sp = quant4.quantize_blockwise_4bit(x, table)  # CPU: the plain version
    back_k = quant4.dequantize_blockwise_4bit(pk, sk, table)
    back_p = quant4.dequantize_blockwise_4bit(pp, sp, table)
    torch.cuda.synchronize()
    assert torch.equal(pk.cpu(), pp) and torch.equal(sk.cpu(), sp)
    assert torch.equal(back_k.cpu(), back_p)
    assert quant4.LAUNCHES["quantize_blockwise_4bit"] - before["quantize_blockwise_4bit"] == 1
    assert quant4.LAUNCHES["dequantize_blockwise_4bit"] - before["dequantize_blockwise_4bit"] == 1


@pytest.mark.cuda
def test_quant4_wrappers_reject_bad_operands(cuda):
    table = mapping_table("de", 4, True, "cpu")
    with pytest.raises(ValueError, match="shape"):
        quant4.quantize_blockwise_4bit(torch.zeros(4, 200, device=cuda), table)
    with pytest.raises(ValueError, match="contiguous"):
        quant4.quantize_blockwise_4bit(torch.zeros(256, 4, device=cuda).t(), table)
    with pytest.raises(TypeError):
        quant4.quantize_blockwise_4bit(torch.zeros(4, 128, device=cuda, dtype=torch.float16), table)
    codes = torch.zeros(4, 64, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="scales shape"):
        quant4.dequantize_blockwise_4bit(codes, torch.ones(4, 2, device=cuda), table)


@pytest.mark.cuda
def test_q4_engine_on_card_matches_cpu(cuda):
    """A short q4 engine run on the card against the same run on the CPU:
    B2 and B3 launched once per leaf and per leaf and phase, the q4 trees
    bit-equal, prefill logits within 2e-2 (bf16 products round differently
    on the two devices), all streams run to their length."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_model, init_serve_cache, named_params, prefill_with_cache
    from repro_torch.serve import Request, ServeEngine, materialize

    cfg = reduced_config("internlm2-1.8b")
    masters = {k: p.detach() for k, p in named_params(init_model(cfg, device="cpu")).items()}
    outs, trees = {}, {}
    for dev in ("cpu", cuda):
        before = dict(quant4.LAUNCHES)
        eng = ServeEngine(cfg, {k: v.to(dev) for k, v in masters.items()}, max_batch=2,
                          s_max=256, weights="q4", drain_every=4)
        reqs = [Request(rid=i, prompt=[3 + i, 4 + i, 5 + i], max_new_tokens=6) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs[str(dev)] = [r.output for r in reqs]
        trees[str(dev)] = eng.params
        n_q = sum(isinstance(v, QuantizedTensor) for v in eng.params.values())
        calls = sum(eng.materialize_calls.values())
        launched = {k: quant4.LAUNCHES[k] - before[k] for k in before}
        if dev == cuda:
            assert launched == {"quantize_blockwise_4bit": n_q,
                                "dequantize_blockwise_4bit": n_q * calls}
            assert len(eng.phase_ms["decode"]) == eng.materialize_calls["decode"]
        else:
            assert launched == {"quantize_blockwise_4bit": 0, "dequantize_blockwise_4bit": 0}
    for k, v in trees["cpu"].items():
        w = trees["cuda"][k]
        if isinstance(v, QuantizedTensor):
            assert torch.equal(w.codes.cpu(), v.codes)
            assert torch.equal(w.scales[0].cpu(), v.scales[0])
        else:
            assert torch.equal(w.cpu(), v)
    assert all(len(o) == 6 for o in outs["cuda"])
    toks, lens = torch.tensor([[3, 4, 5, 6], [7, 8, 0, 0]]), torch.tensor([4, 2])
    logits = {}
    for dev, tree in trees.items():
        cache = init_serve_cache(cfg, 2, 256, device=dev)
        logits[dev] = prefill_with_cache(materialize(tree), cfg, toks.to(dev), lens.to(dev),
                                         cache)[0].cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=2e-2, rtol=0)


def _special_blocks(x: torch.Tensor) -> torch.Tensor:
    """x (R, C) fp32 with one block kind a block, from flat block 1 on, that
    the quantize kernel's fast division does not take: it redoes them with
    __fdiv_rn (a normal block shares its warp step with each)."""
    flat = x.reshape(-1, 128)
    flat[1, 5] = float("nan")
    flat[2, 9] = float("inf")
    flat[3, 9] = float("-inf")
    flat[4, 5], flat[4, 9], flat[4, 77] = float("nan"), float("inf"), float("-inf")
    flat[5] = -0.0
    flat[6] = 0.0
    flat[7, ::7] = 1e-40 * torch.sign(flat[7, ::7])  # subnormal elements in a normal block
    flat[8] *= 1e-40                                   # all subnormal: a subnormal scale
    flat[9, 3], flat[9, 40] = 3.0 * 2.0**61, -(2.0**70)  # a scale above 2^60
    flat[10, 11] = 2.0**-70                            # a tiny normal element
    flat[11] *= 1e-15                                  # a scale below 2^-40
    flat[12, 0] = -(2.0**-40)                          # a scale of exactly 2^-40
    flat[12, 1:] *= 2.0**-42
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 512), (13, 128), (3, 768)])
@pytest.mark.parametrize("table_name", ["de", "linear"])
def test_quant4_kernel_nonfinite_blocks_match_plain(cuda, table_name, shape, x_dtype):
    """NaN (scale 1, as torch.amax keeps it), +-inf, signed zeros, subnormal
    elements and scales, scales above 2^60 and below 2^-40: the exact redo
    path gives the plain version's codes and scales bit for bit, in one
    launch. The signed linear table has a midpoint at zero, so every block
    takes the exact path there."""
    table = mapping_table(table_name, 4, True, "cpu")
    g = torch.Generator().manual_seed(shape[0] + shape[1])
    x = _special_blocks(torch.randn(shape, generator=g)).to(x_dtype)
    before = quant4.LAUNCHES["quantize_blockwise_4bit"]
    pk, sk = quant4.quantize_blockwise_4bit(x.to(cuda), table)
    assert quant4.LAUNCHES["quantize_blockwise_4bit"] - before == 1
    pp, sp = quant4.quantize_blockwise_4bit_plain(x.to(cuda), table)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(sk, sp)
    assert float(sk.reshape(-1)[1]) == 1.0 and float(sk.reshape(-1)[2]) == float("inf")


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_blocks", [1, 3, 384, 100_003])
def test_quant4_kernel_ragged_block_counts(cuda, n_blocks, x_dtype):
    """The persistent grid over ragged work: one block, an odd count (the
    last pair has no second block), a norm leaf's 384, and a prime count far
    above one wave of warps (the grid-stride walk's last pass is ragged)."""
    table = mapping_table("de", 4, True, "cpu")
    g = torch.Generator(device=cuda).manual_seed(n_blocks)
    x = (torch.randn((n_blocks, 128), generator=g, device=cuda) * 0.02).to(x_dtype)
    before = quant4.LAUNCHES["quantize_blockwise_4bit"]
    pk, sk = quant4.quantize_blockwise_4bit(x, table)
    assert quant4.LAUNCHES["quantize_blockwise_4bit"] - before == 1
    pp, sp = quant4.quantize_blockwise_4bit_plain(x, table)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(sk, sp)
    # C = 256 views of the same flat array give the same bytes
    if n_blocks % 2 == 0:
        pk2, sk2 = quant4.quantize_blockwise_4bit(x.reshape(n_blocks // 2, 256), table)
        assert torch.equal(pk2.reshape(-1), pk.reshape(-1))
        assert torch.equal(sk2.reshape(-1), sk.reshape(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("use_sr", [False, True])
def test_update_kernel_nonfinite_gradient_matches_plain(cuda, use_sr):
    """One NaN and one inf gradient element, two steps (the second from the
    first's state, whose rank-1 stats then hold NaN and inf), both passes
    against their plain versions on the card: the m block absmax and the
    rank-1 min(row, col) keep NaN as torch.amax / torch.minimum do (guarded
    scale 1), and the stats pass's uint32 max keeps it too. Codes and m
    scales bit-equal; stats and params equal, NaN counting as equal to NaN."""
    shape = (3, 64, 512)
    w, grad, m_q, v_q = _leaf(shape, 29, use_sr)
    grad[1, 5, 130] = float("nan")
    grad[2, 7, 300] = float("inf")
    grad2 = _leaf(shape, 30, use_sr)[1]
    p, m, v = w.to(cuda), _to(m_q, cuda), _to(v_q, cuda)
    scal = dict(lr=LR, bc1=BC1, bc2=BC2, **HP)
    same = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for t, g in enumerate((grad, grad2)):
        operands, stats = ops.leaf_operands(p, g.to(cuda), m, v, HP["b2"],
                                            sr.PRNGKey(11 + t) if use_sr else None)
        plain_stats = adamw4bit.rank1_new_stats_plain(
            operands["v_packed"], operands["v_r"], operands["v_c"], operands["g"],
            operands["v_table"], HP["b2"], shape)
        k_out = adamw4bit.fused_adamw4(**operands, **scal)
        p_out = adamw4bit.fused_adamw4_plain(**operands, **scal)
        torch.cuda.synchronize()
        for a, b in zip(stats, plain_stats):
            same(a, b)
        for name, a, b in zip(("m codes", "m scales", "v codes"), k_out[1:], p_out[1:]):
            assert torch.equal(a, b), f"step {t}: {name}"
        same(k_out[0], p_out[0])
        if t == 0:
            assert float(k_out[2][1, 5, 1]) == 1.0  # the NaN's block
            assert torch.isnan(stats[-1][130]) and torch.isinf(stats[-1][300])
        p = k_out[0].reshape(shape)
        m = QuantizedTensor(k_out[1].reshape(m.codes.shape), (k_out[2].reshape(m.scales[0].shape),),
                            m.shape, m.config)
        v = QuantizedTensor(k_out[3].reshape(v.codes.shape), stats, v.shape, v.config)


# ---------------------------------------------------------------------------
# checkpoints on the card
# ---------------------------------------------------------------------------


def _ckpt_cfg():
    """The reference's KERNEL_CFG (tests/test_checkpoint_roundtrip.py): the
    mlp w1/w3 leaves (1, 64, 256) take both B1 passes."""
    from repro_torch.models import LayerSpec, ModelConfig

    return ModelConfig(name="micro-kernel-lm", num_layers=1, d_model=64, num_heads=2,
                       num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=256,
                       blocks=(LayerSpec("dense", 0),))


def _ckpt_batch(t, dev):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(256, 16, 8, seed=2))
    return {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(t).items()}


def _ckpt_leaves(state):
    from repro_torch.io.tree import flatten_with_keys

    return [(k, (v.detach().cpu().clone() if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v)))) for k, v in flatten_with_keys(state)]


def _assert_same_leaves(a, b, what):
    assert [k for k, _ in a] == [k for k, _ in b], what
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)), \
            (what, k)


@pytest.mark.cuda
def test_cpu_checkpoint_restores_onto_card_bit_equal(cuda, tmp_path):
    """A checkpoint written from the CPU restores onto the card (params into
    the model's own storage, moments as new device tensors, step counts on
    the host), every leaf bit-equal."""
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.io import restore_checkpoint, save_checkpoint
    from repro_torch.launch.train import abstract_train_state
    from repro_torch.models import init_model
    from repro_torch.train.train_loop import build_train_step, make_train_state

    cfg = _ckpt_cfg()
    opt = make_optimizer("production4bit", 3e-3)
    model = init_model(cfg, device="cpu")
    state = make_train_state(model, opt, key=sr.PRNGKey(17))
    step = build_train_step(model, opt)
    for t in range(2):
        state, _ = step(state, _ckpt_batch(t, "cpu"))
    d = str(tmp_path / "c")
    save_checkpoint(d, 2, state)
    model2, target = abstract_train_state(cfg, make_optimizer("production4bit", 3e-3),
                                          key=sr.PRNGKey(17), device=cuda)
    restored, _ = restore_checkpoint(d, target, device=cuda)
    assert all(p.is_cuda for p in restored.params.values())
    assert {id(p) for p in restored.params.values()} == {id(p) for p in model2.parameters()}
    assert restored.opt_state.states["4bit"].states[0].count.device.type == "cpu"
    _assert_same_leaves(_ckpt_leaves(restored), _ckpt_leaves(state), "CPU -> card")


@pytest.mark.cuda
def test_card_resume_bit_identical_through_b1(cuda, tmp_path):
    """On the card, production4bit with SR: 3 steps, save, 3 more, against a
    restore into a fresh abstract target and the same 3 steps. Both B1
    passes run in the resumed steps; every leaf is bit-equal."""
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.io import save_checkpoint
    from repro_torch.io import restore_checkpoint
    from repro_torch.launch.train import abstract_train_state
    from repro_torch.models import init_model
    from repro_torch.train.train_loop import build_train_step, make_train_state

    cfg = _ckpt_cfg()
    opt = make_optimizer("production4bit", 3e-3)
    model = init_model(cfg, device=cuda)
    state = make_train_state(model, opt, key=sr.PRNGKey(17))
    step = build_train_step(model, opt)
    for t in range(3):
        state, _ = step(state, _ckpt_batch(t, cuda))
    d = str(tmp_path / "c")
    save_checkpoint(d, 3, state)
    for t in range(3, 6):
        state, _ = step(state, _ckpt_batch(t, cuda))

    opt2 = make_optimizer("production4bit", 3e-3)
    model2, target = abstract_train_state(cfg, opt2, key=sr.PRNGKey(17), device=cuda)
    restored, _ = restore_checkpoint(d, target, device=cuda)
    step2 = build_train_step(model2, opt2)
    before = dict(adamw4bit.LAUNCHES)
    for t in range(3, 6):
        restored, _ = step2(restored, _ckpt_batch(t, cuda))
    torch.cuda.synchronize()
    for name in ("fused_adamw4", "rank1_new_stats"):
        assert adamw4bit.LAUNCHES[name] - before[name] == 2 * 3, name  # w1, w3 a step
    _assert_same_leaves(_ckpt_leaves(restored), _ckpt_leaves(state), "card resume @6")


@pytest.mark.cuda
@pytest.mark.parametrize("use_sr", [False, True])
def test_b1_after_a_change_of_current_device(cuda, use_sr):
    """B1's grids are sized from the current card on every launch: both
    passes, launched on card 0, then card 1, then card 0 again, give the
    plain version's results bit for bit each time."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    shape = (3, 128, 768)
    w, grad, m_q, v_q = _leaf(shape, 41, use_sr)
    key = sr.PRNGKey(9) if use_sr else None
    want = ops.fused_adamw4_leaf(w.clone(), grad, m_q, v_q, LR, HP["b1"], HP["b2"], HP["eps"],
                                 HP["weight_decay"], BC1, BC2, key=key)
    for index in (0, 1, 0):
        dev = torch.device("cuda", index)
        with torch.cuda.device(dev):
            got = ops.fused_adamw4_leaf(w.clone().to(dev), grad.to(dev), _to(m_q, dev),
                                        _to(v_q, dev), LR, HP["b1"], HP["b2"], HP["eps"],
                                        HP["weight_decay"], BC1, BC2, key=key)
            torch.cuda.synchronize(dev)
        assert torch.equal(got[1].codes.cpu(), want[1].codes), index
        assert torch.equal(got[2].codes.cpu(), want[2].codes), index
        assert torch.equal(got[1].scales[0].cpu(), want[1].scales[0]), index
        for a, b in zip(got[2].scales, want[2].scales):
            assert torch.equal(a.cpu(), b), index
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
def test_cli_resume_on_card_keeps_no_second_state(cuda, tmp_path):
    """The train CLI at reduced size on the card: the resumed run ends with
    the saving run's losses, and its peak (restore included) holds no second
    copy of the optimizer state: a reference kept to the restore target once
    held one. The bound allows the caching allocator's block rounding, which
    in a process shared with other tests differed by 15 KB on an H100;
    phase 10 of chip_smoke.py holds the full-size runs to equal peaks."""
    from repro_torch.launch import train

    args = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "5", "--batch", "2",
            "--seq", "16", "--optimizer", "production4bit", "--sr-seed", "0",
            "--ckpt-dir", str(tmp_path / "c"), "--ckpt-every", "3", "--keep-last", "1"]
    torch.cuda.empty_cache()
    first = train.main(args)
    losses = [r["loss"] for r in first["steps"]]
    peak = first["peak_bytes"]
    del first
    torch.cuda.empty_cache()
    second = train.main(args)
    assert second["checkpoint"]["resumed_from"] == 3
    assert [r["loss"] for r in second["steps"]] == losses[3:]
    assert second["peak_bytes"] < peak + second["state_bytes"] // 2, (second["peak_bytes"], peak)


# ---------------------------------------------------------------------------
# the last optimizer slice: q4 leaves without a kernel view, the new
# optimizers, the gradient wire formats and the leafwise compressed()
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_q4_odd_leaf_and_kernel_leaves_on_card_match_cpu(cuda):
    """A leaf without a kernel view takes the plain quantizer on the card
    too, a kernel leaf takes B2/B3; both bit-equal to the CPU's tree."""
    from repro_torch.serve import materialize, prepare_params

    g = torch.Generator().manual_seed(5)
    masters = {"head": torch.randn(64, 257, generator=g) * 0.02,
               "w": torch.randn(64, 256, generator=g) * 0.02,
               "x": torch.randn(3, 50, 77, generator=g) * 0.02}
    before = dict(quant4.LAUNCHES)
    card = prepare_params({k: v.to(cuda) for k, v in masters.items()}, "q4")
    card_out = materialize(card)
    torch.cuda.synchronize()
    assert quant4.LAUNCHES["quantize_blockwise_4bit"] - before["quantize_blockwise_4bit"] == 1
    assert quant4.LAUNCHES["dequantize_blockwise_4bit"] - before["dequantize_blockwise_4bit"] == 1
    cpu = prepare_params(masters, "q4")
    cpu_out = materialize(cpu)
    for k in masters:
        assert torch.equal(card[k].codes.cpu(), cpu[k].codes), k
        assert torch.equal(card[k].scales[0].cpu(), cpu[k].scales[0]), k
        assert torch.equal(card_out[k].cpu(), cpu_out[k]), k


def _tiny_tree(dev):
    g = torch.Generator().manual_seed(3)
    tree = {"w2d": torch.randn(40, 300, generator=g) * 0.02,
            "w3d": torch.randn(2, 24, 160, generator=g) * 0.02,
            "v1d": torch.randn(5000, generator=g) * 0.02,
            "s0d": torch.tensor(0.5)}
    return {k: v.to(dev) for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name,ov", [
    ("sm3", {}), ("adafactor", {}), ("adafactor", {"b1": 0.0}), ("factor4bit", {}),
    ("shampoo32", {"precond_every": 2}), ("shampoo4bit", {"precond_every": 2}),
], ids=["sm3", "adafactor", "adafactor_b1_0", "factor4bit", "shampoo32", "shampoo4bit"])
def test_new_optimizers_on_card_match_cpu(cuda, name, ov):
    """Three steps from the same params and grads on the card and on the
    CPU: float state leaves and params within 1e-5 of the leaf's largest
    magnitude (cuBLAS and the reductions sum in other orders; torch's CPU
    sqrt is not correctly rounded), Shampoo's inverse roots within 1e-4
    (2.9e-5 measured on an H100 80GB HBM3 at 700 W when the card's roots
    came from cuSOLVER's fp32 eigh; the card's batches now go through the
    host's LAPACK, ``transform.host_eigh``), 4-bit codes agreeing at 99% or
    more."""
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.io.tree import flatten_with_keys

    states, params = {}, {}
    for tag, dev in (("cpu", "cpu"), ("card", cuda)):
        opt = make_optimizer(name, 1e-3, **ov)
        p = _tiny_tree(dev)
        s = opt.init(p)
        g = torch.Generator().manual_seed(11)
        for _ in range(3):
            grads = {k: (torch.randn(v.shape, generator=g) * 1e-2).to(dev) for k, v in p.items()}
            p, s = opt.update(grads, s, p)
        states[tag] = [(k, v.detach().cpu()) for k, v in flatten_with_keys(s)]
        params[tag] = {k: v.cpu() for k, v in p.items()}
    def close(a, b, what):
        tol = 1e-4 if "precond" in what else 1e-5
        scale = float(b.abs().max()) if b.numel() else 0.0
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * scale, msg=lambda m: f"{what}: {m}")
    assert [k for k, _ in states["card"]] == [k for k, _ in states["cpu"]]
    for (k, a), (_, b) in zip(states["card"], states["cpu"]):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == torch.uint8:
            agree = float(torch.cat([(a & 15) == (b & 15), (a >> 4) == (b >> 4)]).float().mean())
            assert agree >= 0.99, (k, agree)
        elif a.dtype == torch.float32:
            close(a, b, k)
        else:
            assert torch.equal(a, b), k
    for k in params["cpu"]:
        close(params["card"][k], params["cpu"][k], k)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("use_sr", [False, True], ids=["rtn", "sr"])
def test_wire_formats_on_card_match_cpu(cuda, mode, use_sr):
    """reduce_grads on the card equals the CPU's bit for bit: the cast, the
    transport codes and scales, and the Threefry noise."""
    from repro_torch.comms import CommsConfig, grad_comm_key, reduce_grads

    tree = _tiny_tree("cpu")
    key = grad_comm_key(sr.PRNGKey(3), 7) if use_sr else None
    cfg = CommsConfig(mode=mode)
    want = reduce_grads(tree, None, None, cfg, key=key)
    got = reduce_grads({k: v.to(cuda) for k, v in tree.items()}, None, None, cfg, key=key)
    for k in tree:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].cpu().reshape(-1).view(torch.uint8),
                           want[k].reshape(-1).view(torch.uint8)), k


@pytest.mark.cuda
def test_leafwise_compressed_keeps_kernel_leaves_bit_equal(cuda):
    """One production4bit SR step on the card through compressed(), leaf by
    leaf: the fused leaf's params, codes and scales equal a direct
    fused_adamw4_leaf call with the partition's and the leaf's keys."""
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.core.optimizers.schedule import fp32_power

    g = torch.Generator().manual_seed(4)
    n = lambda *shape: (torch.randn(shape, generator=g) * 0.02).to(cuda)
    params = {"decoder/0/sub0/attn/wq": n(1, 64, 2, 32), "decoder/0/sub0/mlp/w1": n(1, 64, 256),
              "embed": n(256, 64), "head": n(64, 256)}
    grads = {k: n(*v.shape) * 0.5 for k, v in params.items()}
    opt = make_optimizer("production4bit", 3e-3)
    state = opt.init(params)
    inner = state.states["4bit"].states[0].inner
    w1 = "decoder/0/sub0/mlp/w1"
    m0, v0 = inner.m[w1], inner.v[w1]
    step_key = sr.fold_in(sr.PRNGKey(17), 0)
    # the 4bit partition is label 0; w1 is its second leaf (after wq)
    leaf_key = sr.fold_in(sr.fold_in(step_key, 0), 1)
    want = ops.fused_adamw4_leaf(params[w1].clone(), grads[w1], m0, v0, np.float32(3e-3),
                                 0.9, 0.999, 1e-8, 0.01, np.float32(1) - fp32_power(0.9, 1),
                                 np.float32(1) - fp32_power(0.999, 1), key=leaf_key)
    before = dict(adamw4bit.LAUNCHES)
    new_params, new_state = opt.update(grads, state, params, key=step_key)
    torch.cuda.synchronize()
    assert adamw4bit.LAUNCHES["fused_adamw4"] - before["fused_adamw4"] == 1
    inner2 = new_state.states["4bit"].states[0].inner
    assert torch.equal(new_params[w1], want[0])
    assert torch.equal(inner2.m[w1].codes, want[1].codes)
    assert torch.equal(inner2.m[w1].scales[0], want[1].scales[0])
    assert torch.equal(inner2.v[w1].codes, want[2].codes)
    for a, b in zip(inner2.v[w1].scales, want[2].scales):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the recurrences and recurrent blocks (plain torch ops) on the card
# ---------------------------------------------------------------------------


def _rel(a, b):
    a, b = a.cpu().double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
def test_gla_chunked_on_card_matches_cpu(cuda, normalize):
    """gla_chunked (S not a whole number of chunks, from an init state) and
    three decode steps after it, card against CPU: fp32 within 1e-5 of the
    output's scale (einsums sum in other orders)."""
    from repro_torch.models.gla import GLAState, gla_chunked, gla_decode_step

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(5)
    B, S, H, dk, dv = 2, 37, 3, 16, 32
    q, k = torch.randn(B, S, H, dk, generator=g), torch.randn(B, S, H, dk, generator=g) * 0.3
    v = torch.randn(B, S, H, dv, generator=g)
    log_a = -torch.rand(B, S, H, generator=g) * 0.2
    st = GLAState(torch.randn(B, H, dk, dv, generator=g), torch.randn(B, H, dk, generator=g))
    outs = {}
    for dev in ("cpu", cuda):
        to = lambda t: t.to(dev)  # noqa: E731
        y, s = gla_chunked(to(q[:, :34]), to(k[:, :34]), to(v[:, :34]), to(log_a[:, :34]),
                           chunk=16, normalize=normalize, init_state=GLAState(*map(to, st)))
        ys = [y]
        for t in range(34, S):
            yt, s = gla_decode_step(*(to(x[:, t:t + 1]) for x in (q, k, v, log_a)), s,
                                    normalize=normalize)
            ys.append(yt)
        outs[str(dev)] = (torch.cat(ys, dim=1), s)
    (yc, sc), (yg, sg) = outs["cpu"], outs[str(cuda)]
    assert _rel(yg, yc) <= 1e-5
    for a, b in zip(sg, sc):
        assert _rel(a, b) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_slstm_scan_on_card_matches_cpu(cuda, masked):
    """slstm_scan from bf16 gate inputs, card against CPU: h within one bf16
    rounding, the fp32 state within 1e-5 of its scale; masked rows frozen
    alike."""
    from repro_torch.models.gla import slstm_scan

    g = torch.Generator().manual_seed(6)
    B, S, H, dh = 3, 13, 4, 16
    gates = torch.randn(B, S, 4, H * dh, generator=g).to(torch.bfloat16)
    r = torch.randn(H, 4, dh, dh, generator=g) * 0.3
    mask = torch.arange(S)[None, :] < torch.tensor([13, 7, 1])[:, None] if masked else None
    hc, sc = slstm_scan(gates, r, H, step_mask=mask)
    hg, sg = slstm_scan(gates.to(cuda), r.to(cuda), H,
                        step_mask=None if mask is None else mask.to(cuda))
    assert float((hg.cpu().float() - hc.float()).abs().max()) <= 2.0 ** -7
    for a, b in zip(sg, sc):
        assert _rel(a, b) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "hymba-1.5b"])
def test_recurrent_arch_step_on_card_matches_cpu(cuda, arch):
    """One training step's loss and gradients of each reduced recurrent arch
    (mLSTM, sLSTM, hymba blocks), then a batched prefill and three decode
    steps, card against CPU from the same weights: loss within 3e-4
    relative, gradients within 3e-2 relative L2, logits within 2e-2 (bf16
    products sum in other orders)."""
    from repro_torch.configs import reduced_config
    from repro_torch.convert import load_params
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import (decode_step, init_model, init_serve_cache, loss_fn,
                                    named_params, prefill_with_cache)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch)
    cpu_model = init_model(cfg, seed=0, device="cpu")
    card_model = init_model(cfg, device="meta").to_empty(device=cuda)
    load_params(card_model, {k: p.detach() for k, p in named_params(cpu_model).items()})
    b = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4)).batch_at(0)
    losses = {}
    for tag, model, dev in (("cpu", cpu_model, "cpu"), ("card", card_model, cuda)):
        loss, _ = loss_fn(model, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        loss.backward()
        losses[tag] = float(loss.detach())
    assert abs(losses["card"] - losses["cpu"]) <= 3e-4 * abs(losses["cpu"])
    card_p = named_params(card_model)
    for k, p in named_params(cpu_model).items():
        err = float((card_p[k].grad.cpu() - p.grad).norm() / p.grad.norm().clamp_min(1e-12))
        assert err < 3e-2, (k, err)
    toks = torch.tensor([[5, 6, 7, 8, 9, 10, 11, 12, 13], [9, 10, 0, 0, 0, 0, 0, 0, 0]])
    lens = torch.tensor([9, 2])
    logits = {}
    with torch.no_grad():
        for tag, model, dev in (("cpu", cpu_model, "cpu"), ("card", card_model, cuda)):
            params = {k: p.detach() for k, p in named_params(model).items()}
            c = init_serve_cache(cfg, 2, 256, device=dev)
            lg, c = prefill_with_cache(params, cfg, toks.to(dev), lens.to(dev), c)
            out = [lg.cpu()]
            tok = torch.tensor([3, 4], device=dev)
            for t in range(3):
                lg, c = decode_step(params, cfg, c, tok, lens.to(dev) + t)
                out.append(lg.cpu())
            logits[tag] = torch.stack(out)
    assert float((logits["card"] - logits["cpu"]).abs().max()) < 2e-2

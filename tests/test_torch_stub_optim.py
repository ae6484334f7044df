"""The optimizer and q4 serving on the port's modality-stub archs
(whisper-large-v3, qwen2-vl-2b) against the JAX reference, on the CPU.

* The optimizer alone, eager on both sides (jitted JAX contracts FMAs, the
  port does not): one production4bit SR update of each reduced tree from
  the reference's params and the same seeded gradients. The reduced trees
  take the full ones' routes: ``mlp/w1`` (last dim 256) through B1 (its
  plain version on the CPU), ``wq``/``wk``/``wv``/``wo`` and ``mlp/w2``
  4-bit and unfused, the LayerNorm leaves (``/scale``, ``/bias``), the
  embedding and qwen2-vl's RMS norms fp32. Every state leaf bit-equal
  (codes, scales, step counts, fp32 moments; the SR keys go by leaf path),
  params within 1e-6 relative, labels equal.
* Full size (meta tensors): labels and B1 routes as the reference's
  (whisper 7 fused leaves of 996,147,200 elements, 471,859,200 unfused
  4-bit, 66,803,200 fp32; qwen2-vl 4 fused of 1,222,115,328, 88,080,384
  unfused, 233,461,248 fp32); production4bit state bytes equal to the
  reference's ``eval_shape`` count (2,048,477,144 / 3,218,982,808 B); q4 /
  bf16 weight bytes equal to its ``weight_report`` (815,385,360 /
  3,069,629,440 B and 820,073,088 / 3,087,316,992 B), row by row, every q4
  leaf with a kernel view; whisper's stacked LayerNorm scales and biases
  ``(32, 1280)`` are q4 leaves (the reference's rank >= 2, > 4096 rule),
  its top-level norms ``(1280,)`` are not.
* q4 serving at the reduced configs: ``prepare_params`` codes and scales
  bit-equal leaf by leaf, ``materialize`` equal; from the q4 weights,
  whisper's ``encode`` plus six ``decode_step(enc_out=)`` and qwen2-vl's
  ``prefill`` over embeds and image positions plus six decode steps,
  logits within 2e-2 absolute of the reference's
  (``tests/test_torch_serving.py``'s bound).

Also here: the structural state bytes of every optimizer at full size
(``tests/test_torch_optim.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config, reduced_config as j_reduced  # noqa: E402
from repro.core.optimizers import (  # noqa: E402
    make_optimizer as j_make,
    state_nbytes as j_state_nbytes,
)
from repro.core.optimizers.presets import production_labels as j_labels  # noqa: E402
from repro.core.optimizers.schedule import linear_warmup_linear_decay as j_sched  # noqa: E402
from repro.core.quantizer import QuantizedTensor as JQ  # noqa: E402
from repro.models import (  # noqa: E402
    decode_step as j_decode_step,
    init_model as j_init,
    init_serve_cache as j_init_serve_cache,
    prefill as j_prefill,
)
from repro.models.layers import (  # noqa: E402
    COMPUTE_DTYPE as J_COMPUTE,
    sinusoidal_positions as j_sinusoidal_positions,
)
from repro.models.model import (  # noqa: E402
    _final_norm as j_final_norm,
    _run_units as j_run_units,
    plan_scan_units as j_plan,
)
from repro.serve import (  # noqa: E402
    materialize as j_materialize,
    prepare_params as j_prepare_params,
    weight_report as j_weight_report,
)
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax, serving_params_from_jax  # noqa: E402
from repro_torch.core.optimizers import make_optimizer, state_nbytes  # noqa: E402
from repro_torch.core.optimizers.base import _leaves  # noqa: E402
from repro_torch.core.optimizers.presets import production_labels  # noqa: E402
from repro_torch.core.optimizers.schedule import linear_warmup_linear_decay  # noqa: E402
from repro_torch.core.quantizer import QuantizedTensor  # noqa: E402
from repro_torch.kernels import sr  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    encode,
    init_model,
    init_serve_cache,
    named_params,
    prefill,
)
from repro_torch.serve import materialize, prepare_params, weight_report  # noqa: E402
from repro_torch.serve.weights import kernel_view  # noqa: E402
from test_torch_encdec import encdec_batch  # noqa: E402
from test_torch_optim import _gpt2m_cfg  # noqa: E402
from test_torch_vl import vl_batch  # noqa: E402
from torch_ref import ref_params  # noqa: E402

torch.set_num_threads(1)

WHISPER, VL = "whisper-large-v3", "qwen2-vl-2b"
STUB_ARCHS = [WHISPER, VL]


def _jax_leaves(state):
    out = []
    for leaf in jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, JQ)):
        out += [leaf.codes, *leaf.scales] if isinstance(leaf, JQ) else [leaf]
    return [np.asarray(x) for x in out]


def _torch_leaves(state):
    out = []
    for leaf in _leaves(state):
        out += [leaf.codes, *leaf.scales] if isinstance(leaf, QuantizedTensor) else [leaf]
    return [x.detach().cpu().numpy() for x in out]


def _bits(a):
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _is_fused(label, p):
    return label == "4bit" and p.ndim >= 2 and p.shape[-1] % 256 == 0 and p.numel() > 4096


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_production4bit_sr_update_bit_equal(arch):
    jparams = jax.tree_util.tree_map(
        np.asarray, ref_params(j_reduced(arch)))
    tparams = params_from_jax(jparams, device="cpu")
    jopt = j_make("production4bit", j_sched(1e-3, 1, 10))
    topt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 1, 10))
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    js, ts = jopt.init(jp), topt.init(tparams)
    grads = jax.tree_util.tree_map(
        lambda p: (np.random.default_rng(p.size).normal(size=p.shape) * 1e-2).astype(np.float32),
        jparams)
    jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp,
                         key=jax.random.fold_in(jax.random.PRNGKey(3), 0))
    tparams, ts = topt.update(params_from_jax(grads, device="cpu"), ts, tparams,
                              key=sr.fold_in(sr.PRNGKey(3), 0))
    jl, tl = _jax_leaves(js), _torch_leaves(ts)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape, b.shape)
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"state leaf {i}")
    jflat = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for k, p in tparams.items():
        np.testing.assert_allclose(p.numpy(), jflat[k].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    labels, jlab = production_labels(), j_labels()
    labs = {k: labels(k, p) for k, p in tparams.items()}
    assert labs == {k: jlab(k, None) for k in tparams}
    fused = {k.split("/", 3)[-1] for k, p in tparams.items() if _is_fused(labs[k], p)}
    assert fused == {"mlp/w1"} | ({"mlp/w3"} if arch == VL else set())
    fp32 = {k for k in tparams if labs[k] == "fp32"}
    if arch == WHISPER:
        assert {k.rsplit("/", 1)[-1] for k in fp32} == {"embed", "scale", "bias"}
    else:
        assert fp32 == {"embed", "final_norm", "decoder/0/sub0/norm1", "decoder/0/sub0/norm2"}


# arch -> (B1 leaves, elements by route: B1, unfused 4-bit, fp32; state bytes;
# q4 bytes, q4 leaves, leaves; bf16 bytes): the reference's counts
FULL = {
    WHISPER: (7, (996_147_200, 471_859_200, 66_803_200), 2_048_477_144,
              (815_385_360, 27, 31), 3_069_629_440),
    VL: (4, (1_222_115_328, 88_080_384, 233_461_248), 3_218_982_808,
         (820_073_088, 10, 11), 3_087_316_992),
}


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_full_size_routes_and_bytes_match_reference(arch):
    jparams = jax.eval_shape(lambda k: j_init(k, j_get_config(arch))[0], jax.random.PRNGKey(0))
    params = named_params(init_model(get_config(arch), device="meta"))
    n_fused, routes, state_bytes, (q4_bytes, q4_leaves, n_leaves), bf16_bytes = FULL[arch]
    labels, jlab = production_labels(), j_labels()
    labs = {k: labels(k, p) for k, p in params.items()}
    assert labs == {k: jlab(k, None) for k in params}
    fused = {k for k, p in params.items() if _is_fused(labs[k], p)}
    unfused = {k for k, p in params.items()
               if labs[k] == "4bit" and k not in fused and p.numel() > 4096}
    counts = tuple(sum(params[k].numel() for k in s) for s in (
        fused, unfused, {k for k in params if labs[k] == "fp32"}))
    assert (len(fused), counts) == (n_fused, routes)
    jbytes = j_state_nbytes(jax.eval_shape(lambda: j_make("production4bit", 1e-3).init(jparams)))
    assert state_nbytes(make_optimizer("production4bit", 1e-3).init(params)) == jbytes == \
        state_bytes
    for mode, want in (("q4", q4_bytes), ("bf16", bf16_bytes)):
        t, j = weight_report(params, mode), j_weight_report(jparams, mode)
        assert t["total_serve_bytes"] == j["total_serve_bytes"] == want, mode
        assert [(r["path"], r["serve_bytes"]) for r in t["leaves"]] == \
            [(r["path"], r["serve_bytes"]) for r in j["leaves"]], mode
        if mode == "q4":
            assert (t["quantized_leaves"], t["n_leaves"]) == (q4_leaves, n_leaves)
    q4 = {k for k, p in params.items() if p.dim() >= 2 and p.numel() > 4096}
    assert len(q4) == q4_leaves and all(kernel_view(tuple(params[k].shape)) for k in q4)
    if arch == WHISPER:
        norms = {k for k in params if "norm" in k}
        assert {k for k in norms if k in q4} == {k for k in norms if "/sub0/" in k}
        assert len(norms & q4) == 10 and all(tuple(params[k].shape) == (32, 1280)
                                             for k in norms & q4)
        assert not {"enc_norm/scale", "final_norm/bias"} & q4


def _j_encode(jcfg, p, frames):
    e = frames.astype(J_COMPUTE) + j_sinusoidal_positions(frames.shape[1], jcfg.d_model)[
        None].astype(J_COMPUTE)
    e, _, _ = j_run_units(jcfg, j_plan(jcfg.encoder_blocks), p["encoder"], e, positions=None)
    return j_final_norm(jcfg, e, p["enc_norm"])


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_q4_serving_matches_reference(arch):
    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    jparams = ref_params(jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jtree = jax.jit(lambda p: j_prepare_params(p, "q4"))(jparams)
    jflat = serving_params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), device="cpu")
    mine = prepare_params(tparams, "q4")
    assert list(mine) == list(jflat)
    for path, ours in mine.items():
        theirs = jflat[path]
        assert isinstance(ours, QuantizedTensor) == isinstance(theirs, QuantizedTensor), path
        if isinstance(theirs, QuantizedTensor):
            assert torch.equal(ours.codes, theirs.codes) and \
                torch.equal(ours.scales[0], theirs.scales[0]), path
        else:
            assert torch.equal(ours, theirs), path
    jq = jax.jit(j_materialize)(jtree)
    jmat = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    tq = materialize(mine)
    for path, x in tq.items():
        assert torch.equal(x.float(), jmat[path]), path

    B, steps = 2, 6
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(B, steps)).astype(np.int32)
    got, want = [], []
    enc, j_enc = None, None
    with torch.no_grad():
        if arch == WHISPER:
            frames = encdec_batch(cfg, 8, B=B, Se=20)["frames"]
            enc = encode(tq, cfg, torch.from_numpy(frames))
            j_enc = jax.jit(lambda p, f: _j_encode(jcfg, p, f))(jq, frames)
        else:
            b = vl_batch(cfg, 8, B=B, S=20)
            got.append(prefill(tq, cfg, {k: torch.from_numpy(b[k]).long() if k == "positions"
                                         else torch.from_numpy(b[k])
                                         for k in ("embeds", "positions")}).numpy())
            want.append(np.asarray(jax.jit(lambda p, bb: j_prefill(p, jcfg, bb))(
                jq, {k: b[k] for k in ("embeds", "positions")})))
        caches, jc = init_serve_cache(cfg, B, 256, device="cpu"), j_init_serve_cache(jcfg, B, 256)
        j_dec = jax.jit(lambda p, c, t, q, e: j_decode_step(p, jcfg, c, t, q, enc_out=e))
        for t in range(steps):
            logits, caches = decode_step(tq, cfg, caches, torch.from_numpy(toks[:, t]).long(),
                                         torch.full((B,), t, dtype=torch.int64), enc_out=enc)
            jl, jc = j_dec(jq, jc, jnp.asarray(toks[:, t]), jnp.full((B,), t, jnp.int32), j_enc)
            got.append(logits.numpy())
            want.append(np.asarray(jl))
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.max(np.abs(a - b)) < 2e-2, (arch, i, np.max(np.abs(a - b)))


@pytest.mark.parametrize("cfg_name,opt_name,expected", [
    ("gpt2m", "production4bit", 1_135_298_392),
    ("gpt2m", "adamw32", 3_239_731_212),
    ("internlm2-1.8b", "production4bit", 4_590_578_552),
    # the reference's eval_shape counts at full internlm2-1.8b size
    ("internlm2-1.8b", "sm3", 7_557_380_132),
    ("internlm2-1.8b", "adafactor", 7_645_301_960),
    ("internlm2-1.8b", "factor4bit", 1_092_458_700),
    ("internlm2-1.8b", "shampoo32", 45_341_376_524),
    ("internlm2-1.8b", "shampoo4bit", 5_963_813_036),
])
def test_structural_state_bytes(cfg_name, opt_name, expected):
    cfg = _gpt2m_cfg() if cfg_name == "gpt2m" else get_config(cfg_name)
    params = named_params(init_model(cfg, device="meta"))
    opt = make_optimizer(opt_name, 1e-3)
    assert state_nbytes(opt.init(params)) == expected

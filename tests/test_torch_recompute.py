"""The port's recompute: layer remat, the cross entropy's recomputed
chunks, and both on the mesh, against the same code without them.

The reference recomputes in the backward where ``ModelConfig.remat`` is on
(each scan body under ``jax.checkpoint``) and in every chunk of its cross
entropy. The port recomputes the same regions (``models.remat.recomputed``)
and runs the forward's own graph backward, so with the recompute on, the
loss and every gradient are bit-equal to the run without it:

* layer remat on against off on reduced internlm2-1.8b, hymba-1.5b,
  mixtral-8x7b (MoE) and whisper-large-v3 (encoder-decoder), after a
  warm-up forward (the CPU build can round ``sqrt`` apart on a process's
  first call); autograd keeps fewer bytes outside the regions with it on;
* the cross entropy, plain, against its chunk loop run once (saved), and
  no chunk's fp32 logits saved; vocab-parallel on a model group of two
  processes, the same;
* the port with remat on against the reference with remat on (reduced
  internlm2-1.8b, the reference's params): loss within 2e-3 relative,
  each gradient leaf within 3e-2 (the bars of ``tests/test_torch_train.py``);
* the mesh step at (2, 1) and (1, 2) in one world of two processes
  (``torch_mesh_worker``'s ``tp_step``, reduced internlm2-1.8b, one step of
  8 x 32): the gradient, the loss and the updated parameters bit-equal to
  remat off, the bytes each step recorded equal to ``MeshStep.reckon``'s,
  call for call, more than without remat (the backward's second gathers
  and sums); the world is killed and the test fails past a timeout;
* the roofline on ``meta``: a remat train layer counts the matmul FLOPs of
  one more forward of the layer, and causal training attention at S = 4096
  counts the FLOPs of its 20 (512, 1024) pairs;
* a cache under autograd with remat on is refused.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import load_params, params_from_jax  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import Transformer, init_model, named_params  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import params_loss  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402
from torch_ref import ref_params  # noqa: E402

ARCH = "internlm2-1.8b"
REMAT_ARCHS = ("internlm2-1.8b", "hymba-1.5b", "mixtral-8x7b", "whisper-large-v3")
LAYOUTS = ((2, 1), (1, 2))
IDS = ["2x1", "1x2"]
WORLD_TIMEOUT_S = 600


def _batch(cfg, B=4, S=32, seed=0):
    b = SyntheticLM(DataConfig(cfg.vocab_size, S, B)).batch_at(seed)
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    if cfg.family == "encdec":
        rng = np.random.default_rng(seed)
        out["frames"] = torch.from_numpy(rng.standard_normal((B, 48, cfg.d_model),
                                                             dtype=np.float32))
    return out


def _vocab_case():
    """A vocab-parallel cross entropy (gemma2's final softcap, a tied head,
    labels partly masked), bf16 compute, chunks of 8."""
    rng = np.random.default_rng(26)
    B, S, D, V = 2, 24, 64, 512
    ids = rng.integers(0, V, (B, S))
    return {"block": "vocab", "arch": "gemma2-2b", "dtype": "bf16",
            "params": {"embed": rng.standard_normal((V, D), dtype=np.float32)},
            "x": rng.standard_normal((B, S, D), dtype=np.float32),
            "cot": rng.standard_normal((B, S, D), dtype=np.float32) * 0.05,
            "ids": ids, "labels": np.where(rng.random((B, S)) < 0.2, -1, ids)}


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """The world of two ranks, started before this file's other tests so
    that they overlap it."""
    cfg = j_reduced(ARCH)
    params = {k: v.numpy() for k, v in params_from_jax(
        jax.device_get(ref_params(cfg)), "cpu").items()}
    batches = [SyntheticLM(DataConfig(cfg.vocab_size, 32, 8)).batch_at(0)]
    step = lambda remat: {"kind": "tp_step", "arch": ARCH, "meshes": list(LAYOUTS),
                          "lr": 1e-3, "sr_seed": 0, "params": params, "batches": batches,
                          "overrides": {"remat": remat}, "whole_params": True}
    blocks = lambda plain: {"kind": "tp_blocks", "cases": [_vocab_case()],
                            "unrecomputed": plain}
    tasks = {"off": step(False), "on": step(True), "ce": blocks(False),
             "ce_plain": blocks(True)}
    started = worker.start(2, tasks, str(tmp_path_factory.mktemp("recompute")))
    yield {"started": started}
    for p in started[0].processes:  # a world that no test collected
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def ranks(world):
    if "ranks" not in world:
        world["ranks"] = worker.collect(world["started"], timeout=WORLD_TIMEOUT_S)
    return world["ranks"]


def _grads(cfg, batch, seed=0):
    model = init_model(cfg, seed=seed, device="cpu")
    params = named_params(model)
    loss, metrics = params_loss(params, cfg, batch)
    loss.backward()
    return loss.detach(), metrics["aux_loss"], {k: p.grad for k, p in params.items()}


def _saved_bytes(fn):
    """Bytes autograd saves outside every recomputed region while ``fn`` runs."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return total[0], out


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_layer_remat_is_bit_equal(arch):
    base = reduced_config(arch)
    batch = _batch(base)
    with torch.no_grad():  # warm-up: the first call's sqrt may round apart
        params_loss(named_params(init_model(base, seed=0, device="cpu")), base, batch)
    off, on = (dataclasses.replace(base, remat=r) for r in (False, True))
    l0, a0, g0 = _grads(off, batch)
    l1, a1, g1 = _grads(on, batch)
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    assert list(g0) == list(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    if arch == "mixtral-8x7b":
        assert float(a1) > 0
    kept = {}
    for name, c in (("off", off), ("on", on)):
        p = named_params(init_model(c, seed=0, device="cpu"))
        kept[name], _ = _saved_bytes(lambda: params_loss(p, c, batch))
    assert kept["on"] < kept["off"], kept


@pytest.mark.parametrize("logit_cap", [0.0, 30.0])
def test_cross_entropy_recompute_is_bit_equal(logit_cap, monkeypatch):
    rng = np.random.default_rng(7)
    B, S, D, V, chunk = 2, 40, 32, 256, 16
    x0 = torch.from_numpy(rng.standard_normal((B, S, D), dtype=np.float32)).to(torch.bfloat16)
    h0 = torch.from_numpy(rng.standard_normal((D, V), dtype=np.float32) * 0.1)
    labels = torch.from_numpy(np.where(rng.random((B, S)) < 0.2, -1,
                                       rng.integers(0, V, (B, S))))

    def run():
        x, h = x0.clone().requires_grad_(), h0.clone().requires_grad_()
        kept, loss = _saved_bytes(lambda: L.chunked_cross_entropy(
            x, h, labels, logit_cap=logit_cap, chunk=chunk))
        loss.backward()
        return loss.detach(), x.grad, h.grad, kept

    recomputed = run()
    monkeypatch.setattr(L, "recomputed", lambda fn, *a: fn(*a))
    plain = run()
    for a, b in zip(recomputed[:3], plain[:3]):
        assert torch.equal(a, b)
    # a chunk's fp32 logits (B, chunk, V) are saved only without the recompute
    assert recomputed[3] < B * chunk * V * 4 <= plain[3], (recomputed[3], plain[3])


def test_port_with_remat_matches_reference():
    jcfg = dataclasses.replace(j_reduced(ARCH), remat=True)
    cfg = dataclasses.replace(reduced_config(ARCH), remat=True)
    jparams = ref_params(j_reduced(ARCH))  # remat changes no parameter
    b = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4)).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(p, jcfg, b), has_aux=True))(
        jparams)
    model = Transformer(cfg, device="cpu")
    load_params(model, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                       device="cpu"))
    loss, _ = model({k: torch.from_numpy(v) for k, v in b.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-3)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), device="cpu")
    for k, p in named_params(model).items():
        ref = want[k].numpy()
        err = np.linalg.norm(p.grad.numpy() - ref) / max(np.linalg.norm(ref), 1e-12)
        assert err < 3e-2, (k, err)


def test_remat_with_a_cache_under_autograd_is_refused():
    from repro_torch.models import init_serve_cache, prefill_with_cache

    cfg = dataclasses.replace(reduced_config(ARCH), remat=True)
    params = named_params(init_model(cfg, seed=0, device="cpu"))
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    lengths = torch.full((2,), 8)
    with pytest.raises(ValueError, match="remat"):
        prefill_with_cache(params, cfg, tokens, lengths,
                           init_serve_cache(cfg, 2, 16, device="cpu"))
    with torch.no_grad():  # serving runs as it is
        logits, _ = prefill_with_cache(params, cfg, tokens, lengths,
                                       init_serve_cache(cfg, 2, 16, device="cpu"))
    assert torch.isfinite(logits).all()


def test_roofline_counts_the_recompute_and_the_pruned_pairs():
    from repro_torch.models.attention import train_attention
    from repro_torch.models.model import plan_scan_units
    from repro_torch.roofline import measured as M

    base = reduced_config(ARCH)
    unit = plan_scan_units(base.blocks)[0]
    B, S = 2, 32
    pos = torch.arange(S, device="meta")[None].expand(B, S)
    probe = lambda cfg, train: M._seq_probe(cfg, unit, "decoder", B, S, pos, train,
                                            torch.float32)
    off = probe(dataclasses.replace(base, remat=False), True)
    on = probe(dataclasses.replace(base, remat=True), True)
    fwd = probe(base, False)
    assert fwd.flops > 0 and on.flops_by_dtype == (off + fwd).flops_by_dtype
    assert on.bytes > off.bytes
    # internlm2-1.8b's train_4k attention (16 q / 8 kv heads of 128), causal:
    # 20 of the 32 (512, 1024) pairs, two products of 2 * 512 * 1024 * 16 * 128
    q = torch.empty((1, 4096, 16, 128), device="meta")
    k = torch.empty((1, 4096, 8, 128), device="meta")
    with M.Counter() as c, torch.no_grad():
        train_attention(q, k, k)
    assert c.flops_by_dtype == {"float32": 20 * 2 * 2 * 512 * 1024 * 16 * 128}


def test_vocab_parallel_cross_entropy_recompute_is_bit_equal(ranks):
    for r in ranks:
        (got,), (want,) = r["ce"], r["ce_plain"]
        assert torch.equal(got["y"]["loss"], want["y"]["loss"])
        assert torch.equal(got["x_grad"], want["x_grad"])
        assert torch.equal(got["grads"]["embed"], want["grads"]["embed"])


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_mesh_remat_is_bit_equal(layout, ranks):
    for r in ranks:
        on, off = r["on"][layout], r["off"][layout]
        assert on["losses"] == off["losses"] and on["aux"] == off["aux"]
        for what in ("grads", "params"):
            assert list(on[what]) == list(off[what])
            for k in on[what]:
                assert torch.equal(on[what][k], off[what][k]), (what, k)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_mesh_remat_bytes_equal_the_reckoning(layout, ranks):
    for rank, r in enumerate(ranks):
        on, off = r["on"][layout], r["off"][layout]
        for res in (on, off):
            result_bytes, calls = res["reckoned"]
            for stats, recorded in zip(res["stats_bytes"], res["recorded"]):
                assert stats == result_bytes > 0, (layout, rank)
                assert sorted(recorded) == sorted(calls), (layout, rank)
        # the backward gathers each layer again (and sums a model group's
        # partials again, where the compute is split)
        assert on["reckoned"][0] > off["reckoned"][0], (layout, rank)

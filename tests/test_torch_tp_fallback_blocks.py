"""The ``embed``-cut fallbacks of the port's mesh step against their
one-process functions (``sharding.tensor_parallel``), forward and
gradients: where the model axis divides neither the heads nor the
vocabulary, the reference's rules cut those leaves on ``embed``.

Two spawned worlds, each one model group (``torch_mesh_worker``'s
``fallback_blocks``: 2 and 4 gloo ranks, started before the one-process
side runs here): every rank computes its model shard of the block on the
same inputs (made with numpy from a seed), its leaves cut as the placement
rule cuts them (``fallback_cuts``), and the test joins the shards'
gradients. The blocks, at 2 x 12 tokens:

* row-parallel self-attention: 3 heads at d_model 48 on 2 and 4 ranks, 6
  heads at d_model 96 on 4 (on 2 they would split by heads);
* GQA, 3 heads on 1 kv head with qwen3's q/k norms, on 2;
* gemma2's sliding window (6) and attention softcap, 3 heads, on 2;
* whisper's cross-attention over a 10-frame source, 3 heads, on 2;
* the column-parallel lookup, vocab 513 at d_model 48, on 2 and 4;
* the row-parallel cross entropy, vocab 511 at d_model 48, on 2 and 4:
  untied, and tied (the head ``embed.T``) with gemma2's final softcap;
  labels partly masked, chunks of 8.

Bars (``tests/test_torch_tp_blocks.py``'s): fp32 compute, 2e-6 of each
tensor's largest magnitude (the partial sums add in another order); bf16
compute, the attention's output within one bf16 rounding of the
one-process output (2^-8 of the largest magnitude) and the gradients within
2e-2 of theirs; the loss within 2e-6 relative in both; the lookup's rows
and table gradient bit-equal in both. Every rank's output and input gradients
bit-equal, as is the gradient of a leaf held whole; each rank ran its
mode (``tensor_parallel.CALLS``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worker as worker  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402

B, S, SE = 2, 12, 10
FP32_BAR, BF16_OUT_BAR, BF16_GRAD_BAR = 2e-6, 2.0 ** -8, 2e-2
# the cut each case's mode needs, on every world it runs on
MODE = {"attention": ("wq", 0), "lookup": ("embed", 1), "ce": ("head", 0),
        "ce-tied": ("embed", 1)}
CALL = {"attention": "row_parallel_attention", "lookup": "column_parallel_lookup",
        "ce": "row_parallel_cross_entropy", "ce-tied": "row_parallel_cross_entropy"}


def _normal(rng, *shape, scale=0.05):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _attention(rng, D, H, Hkv, dh=16, qk=False):
    p = {"wq": _normal(rng, D, H, dh), "wk": _normal(rng, D, Hkv, dh),
         "wv": _normal(rng, D, Hkv, dh), "wo": _normal(rng, H, dh, D)}
    if qk:
        p.update(q_norm=1 + _normal(rng, dh), k_norm=1 + _normal(rng, dh))
    return p


def cases():
    """The blocks in both compute types; the same list on every rank and
    here."""
    rng = np.random.default_rng(29)
    three = {"d_model": 48, "num_heads": 3, "num_kv_heads": 3}
    base = [
        {"name": "attention-3h", "block": "attention", "arch": "internlm2-1.8b", "cfg": three,
         "params": _attention(rng, 48, 3, 3), "worlds": (2, 4)},
        {"name": "attention-6h", "block": "attention", "arch": "internlm2-1.8b",
         "cfg": {"d_model": 96, "num_heads": 6, "num_kv_heads": 6},
         "params": _attention(rng, 96, 6, 6), "worlds": (4,)},
        {"name": "gqa-qk-norm", "block": "attention", "arch": "qwen3-4b",
         "cfg": {"d_model": 48, "num_heads": 3, "num_kv_heads": 1},
         "params": _attention(rng, 48, 3, 1, qk=True), "worlds": (2,)},
        {"name": "window-softcap", "block": "attention", "arch": "gemma2-2b", "cfg": three,
         "params": _attention(rng, 48, 3, 3), "window": 6, "worlds": (2,)},
        {"name": "cross", "block": "attention", "arch": "whisper-large-v3", "cfg": three,
         "params": _attention(rng, 48, 3, 3), "source": _normal(rng, B, SE, 48, scale=1.0),
         "worlds": (2,)},
        {"name": "lookup", "block": "lookup", "arch": "internlm2-1.8b",
         "cfg": {"d_model": 48, "vocab_size": 513},
         "params": {"embed": _normal(rng, 513, 48, scale=1.0)},
         "ids": rng.integers(0, 513, (B, S)), "worlds": (2, 4)},
        {"name": "ce", "block": "ce", "arch": "internlm2-1.8b",
         "cfg": {"d_model": 48, "vocab_size": 511},
         "params": {"head": _normal(rng, 48, 511, scale=0.2)}, "worlds": (2, 4)},
        {"name": "ce-tied", "block": "ce", "arch": "gemma2-2b",
         "cfg": {"d_model": 48, "vocab_size": 511},
         "params": {"embed": _normal(rng, 511, 48, scale=0.2)}, "worlds": (2, 4)},
    ]
    out = []
    for c in base:
        D = c["cfg"]["d_model"]
        x = _normal(rng, B, S, D, scale=1.0)
        cot = _normal(rng, B, S, D, scale=1.0)
        if c["block"] == "ce":
            V = c["cfg"]["vocab_size"]
            ids = rng.integers(0, V, (B, S))
            c = dict(c, labels=np.where(rng.random((B, S)) < 0.2, -1, ids))
        for dtype in ("fp32", "bf16"):
            out.append(dict(c, x=x, cot=cot, dtype=dtype))
    return out


CASES = cases()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: worker.start(n, {"blocks": {"kind": "fallback_blocks", "cases": CASES}},
                            str(tmp_path_factory.mktemp(f"tp_fallback{n}"))) for n in (2, 4)}


@pytest.fixture(scope="module")
def results(worlds):
    return {n: [r["blocks"] for r in worker.collect(started)] for n, started in worlds.items()}


def one_process(case):
    dtype = torch.float32 if case["dtype"] == "fp32" else torch.bfloat16
    with worker._compute_dtype(dtype):
        cfg = dataclasses.replace(reduced_config(case["arch"]), **case["cfg"])
        p = {k: torch.from_numpy(v).clone().requires_grad_() for k, v in case["params"].items()}
        x = torch.from_numpy(case["x"]).to(dtype).requires_grad_()
        y, total, src = worker.fallback_apply(case, p, x, cfg)
        total.backward()
    return {"y": y.detach(), "x_grad": x.grad, "src_grad": None if src is None else src.grad,
            "grads": {k: v.grad for k, v in p.items()}}


def gaps(ranks, case):
    """Max abs difference over the largest magnitude of the output, the
    inputs' gradients and each leaf's gradient (the shards joined) against
    the one-process function; every rank's replicated tensors bit-equal."""
    want = one_process(case)
    rel = lambda a, b: float((a.float() - b.float()).abs().max() / b.float().abs().max())
    out = {}
    for k in ("y", "x_grad", "src_grad"):
        if want[k] is None:
            continue
        for r in ranks[1:]:
            assert torch.equal(r[k], ranks[0][k]), k
        out[k] = rel(ranks[0][k], want[k])
    cuts = worker.fallback_cuts(case["block"], {k: v.shape for k, v in case["params"].items()},
                                len(ranks))
    for k, w in want["grads"].items():
        g = [r["grads"][k] for r in ranks]
        if cuts[k] is None:
            assert all(torch.equal(o, g[0]) for o in g[1:]), k
            joined = g[0]
        else:
            joined = torch.cat(g, dim=cuts[k])
        out[k] = rel(joined, w)
    return out, cuts


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c['name']}-{c['dtype']}" for c in CASES])
def test_fallback_against_one_process(results, i):
    case = CASES[i]
    mode = "ce-tied" if case["name"] == "ce-tied" else case["block"]
    for world in case["worlds"]:
        ranks = [r[i] for r in results[world]]
        got, cuts = gaps(ranks, case)
        leaf, dim = MODE[mode]
        assert cuts[leaf] == dim, (leaf, cuts)
        assert all(r["calls"][CALL[mode]] > 0 for r in ranks), ranks[0]["calls"]
        print(f"{case['name']} {case['dtype']} on {world} ranks: cuts "
              f"{ {k: d for k, d in cuts.items() if d is not None} }; {got}")
        for k, v in got.items():
            if case["block"] == "lookup":  # each column's row and sums as one process's
                assert v == 0.0, (k, world, got)
                continue
            bar = (FP32_BAR if case["dtype"] == "fp32" or (k, case["block"]) == ("y", "ce") else
                   BF16_OUT_BAR if k == "y" else BF16_GRAD_BAR)
            assert v <= bar, (k, world, got)

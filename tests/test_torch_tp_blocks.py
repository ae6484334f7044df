"""Each tensor-parallel block of the port's mesh step against its
one-process function (``sharding.tensor_parallel``), forward and gradients.

Two spawned worlds, each one model group (``torch_mesh_worker``'s
``tp_blocks``: 2 and 4 gloo ranks, started before the one-process side runs
here): every rank computes its model shard of the block on the same inputs
(made with numpy from a seed) and the test joins the shards' gradients.
The blocks, at reduced widths (d_model 64, 16-wide heads):

* head-parallel attention with GQA (4 q heads on 2 kv heads), a sliding
  window of 6, gemma2's attention softcap and qwen3's q/k norms; on 2 ranks
  each rank holds its own kv head (2 divides 2), on 4 the kv weights stay
  whole and each rank slices the kv head its q head reads;
* mlp-parallel MLP, gated (silu, ``w3``) and ungated (tanh gelu);
* the vocab-parallel lookup and cross entropy (gemma2's final softcap, a
  tied head: ``embed.T``, labels partly masked).

Bars: fp32 compute, 2e-6 of each tensor's largest magnitude (the partial
sums add in another order). bf16 compute, with the row-parallel partials in
fp32 and their sum rounded once (what the port runs): outputs within one
bf16 rounding of the one-process output (2^-8 of the largest magnitude) and
gradients within 2e-2 of theirs; the lookup bit-equal in both (one rank's
row and zeros); the loss within 2e-6 relative. The partials kept in bf16
and summed in bf16 (the other choice) are reported beside them
(``scripts_tp_partials.py`` prints both gaps).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worker as worker  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.blocks import apply_attention, apply_mlp  # noqa: E402
from repro_torch.models.layers import chunked_cross_entropy, embed_lookup  # noqa: E402

B, S, D = 2, 12, 64
ATTN_CFG = {"num_heads": 4, "num_kv_heads": 2, "attn_softcap": 50.0, "qk_norm": True}
FP32_BAR, BF16_OUT_BAR, BF16_GRAD_BAR = 2e-6, 2.0 ** -8, 2e-2


def _normal(rng, *shape, scale=0.05):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def cases():
    """The blocks' cases in both compute types; the same list on every rank
    and here."""
    rng = np.random.default_rng(25)
    H, Hkv, dh, F, V = 4, 2, 16, 256, 512
    attn = {"wq": _normal(rng, D, H, dh), "wk": _normal(rng, D, Hkv, dh),
            "wv": _normal(rng, D, Hkv, dh), "wo": _normal(rng, H, dh, D),
            "q_norm": (1 + _normal(rng, dh)), "k_norm": (1 + _normal(rng, dh))}
    mlp = {"w1": _normal(rng, D, F), "w3": _normal(rng, D, F), "w2": _normal(rng, F, D)}
    embed = {"embed": _normal(rng, V, D, scale=1.0)}
    x = _normal(rng, B, S, D, scale=1.0)
    cot = _normal(rng, B, S, D, scale=1.0)
    ids = rng.integers(0, V, (B, S))
    labels = np.where(rng.random((B, S)) < 0.2, -1, ids)
    base = [
        {"block": "attention", "arch": "qwen3-4b", "cfg": ATTN_CFG, "params": attn,
         "window": 6},
        {"block": "mlp", "arch": "internlm2-1.8b", "params": mlp, "act": "silu", "width": F},
        {"block": "mlp", "arch": "whisper-large-v3",
         "params": {k: v for k, v in mlp.items() if k != "w3"}, "act": "gelu", "width": F},
        {"block": "vocab", "arch": "gemma2-2b", "params": embed, "ids": ids, "labels": labels},
    ]
    out = []
    for c in base:
        for dtype, partial in (("fp32", "fp32"), ("bf16", "fp32"), ("bf16", "bf16")):
            out.append(dict(c, x=x, cot=cot, dtype=dtype, partial=partial))
    return out


CASES = cases()
# one test a block and compute type, over both worlds (and both partial
# types in bf16)
GROUPS = {}
for _i, _c in enumerate(CASES):
    GROUPS.setdefault(f"{_c['block']}-{_c.get('act', 'ce')}-{_c['dtype']}", []).append(_i)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: worker.start(n, {"blocks": {"kind": "tp_blocks", "cases": CASES}},
                            str(tmp_path_factory.mktemp(f"tp_blocks{n}"))) for n in (2, 4)}


@pytest.fixture(scope="module")
def results(worlds):
    return {n: [r["blocks"] for r in worker.collect(started)] for n, started in worlds.items()}


def one_process(case):
    """The block's one-process function on the case's inputs."""
    import dataclasses

    dtype = torch.float32 if case["dtype"] == "fp32" else torch.bfloat16
    with worker._compute_dtype(dtype):
        cfg = dataclasses.replace(reduced_config(case["arch"]), **case.get("cfg", {}))
        p = {k: torch.from_numpy(v).clone().requires_grad_() for k, v in case["params"].items()}
        x = torch.from_numpy(case["x"]).to(dtype).requires_grad_()
        cot = torch.from_numpy(case["cot"])
        if case["block"] == "attention":
            pos = torch.arange(S)[None].expand(B, -1)
            y = apply_attention(p, x, cfg, window=case["window"], positions=pos)
            total = (y.float() * cot).sum()
        elif case["block"] == "mlp":
            y = apply_mlp(p, x, case["act"], case["width"])
            total = (y.float() * cot).sum()
        else:
            rows = embed_lookup(p["embed"], torch.from_numpy(case["ids"]))
            loss = chunked_cross_entropy(x, p["embed"].t(), torch.from_numpy(case["labels"]),
                                         logit_cap=cfg.final_softcap, chunk=8)
            y = {"rows": rows.detach(), "loss": loss.detach()}
            total = loss + (rows.float() * cot).sum()
        total.backward()
    return {"y": y.detach() if torch.is_tensor(y) else y, "x_grad": x.grad,
            "grads": {k: v.grad for k, v in p.items()}}


def _joined(ranks, case, k):
    """A leaf's gradient from every rank's shard (a whole leaf's, from rank
    0: each rank holds the whole group's sum)."""
    g = [r["grads"][k] for r in ranks]
    world = len(ranks)
    dim = {"wq": 1, "wo": 0, "wk": 1, "wv": 1, "w1": 1, "w3": 1, "w2": 0, "embed": 0}.get(k)
    if dim is None or g[0].shape == case["params"][k].shape:
        for other in g[1:]:
            assert torch.equal(other, g[0]), k
        return g[0]
    assert g[0].shape[dim] * world == case["params"][k].shape[dim]
    return torch.cat(g, dim=dim)


def gaps(ranks, case):
    """Max abs difference over the largest magnitude of each output and
    gradient (the shards joined) against the one-process function."""
    want = one_process(case)
    rel = lambda a, b: float((a.float() - b.float()).abs().max() / b.float().abs().max())
    out = {}
    if isinstance(want["y"], dict):
        out["rows"] = rel(ranks[0]["y"]["rows"], want["y"]["rows"])
        out["loss"] = rel(ranks[0]["y"]["loss"], want["y"]["loss"])
        for r in ranks[1:]:
            assert torch.equal(r["y"]["loss"], ranks[0]["y"]["loss"])
    else:
        out["y"] = rel(ranks[0]["y"], want["y"])
        for r in ranks[1:]:  # the sum's bits are the whole group's
            assert torch.equal(r["y"], ranks[0]["y"])
    out["x_grad"] = rel(ranks[0]["x_grad"], want["x_grad"])
    for r in ranks[1:]:
        assert torch.equal(r["x_grad"], ranks[0]["x_grad"])
    for k in want["grads"]:
        out[k] = rel(_joined(ranks, case, k), want["grads"][k])
    return out


@pytest.mark.parametrize("group", list(GROUPS))
def test_block_against_one_process(results, group):
    for i in GROUPS[group]:
        case = CASES[i]
        for world in (2, 4):
            got = gaps([r[i] for r in results[world]], case)
            print(f"{group} partials {case['partial']} on {world} ranks: {got}")
            if case["partial"] == "bf16":  # the other choice: held to the gradient bar only
                assert all(v <= BF16_GRAD_BAR for v in got.values()), got
                continue
            for k, v in got.items():
                if k == "rows":
                    assert v == 0.0, got  # exactly one rank's row, and zeros
                elif case["dtype"] == "fp32" or k == "loss":
                    assert v <= FP32_BAR, (k, got)
                elif k == "y":
                    assert v <= BF16_OUT_BAR, (k, got)
                else:
                    assert v <= BF16_GRAD_BAR, (k, got)

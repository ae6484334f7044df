"""Each recurrent block of the port's mesh step computing on its model
shards against its one-process function (``models.blocks.apply_mlstm``,
``apply_slstm``, ``apply_hymba`` under ``sharding.tensor_parallel.use``),
forward and gradients.

Two spawned worlds, each one model group (``torch_mesh_worker``'s
``recurrent_blocks``: 2 and 4 gloo ranks, started before the one-process
side runs here): every rank computes its model shard of the block on the
same inputs (made with numpy from a seed), its leaves cut as the placement
rule cuts them (``recurrent_cuts``), and the test joins the shards'
gradients. The blocks, at 2 x 24 tokens, GLA chunks of 8:

* mLSTM head-parallel: 4 heads at d_model 64 (2 and 1 a rank); ``w_in``
  and the gate columns joined, ``w_out``'s rows summed;
* mLSTM with 3 heads at d_model 48: no rank count divides the heads, so
  q/k/v are row-parallel and the cells run whole; ``w_if`` cut on its 6
  gate columns on 2 ranks, on its rows (``b_if`` whole) on 4;
* sLSTM head-parallel (4 heads) and whole-cell (3 heads at 48: 24 and 12
  gate columns a rank, ``r_gates`` whole), each with its split MLP;
* hymba head-parallel (4 heads, 8 states; its attention split too);
* hymba state-parallel: 5 heads at d_model 80, 8 states (4 and 2 a rank;
  ``ssm_dt`` on its rows; the full config's case: 25 heads, 16 states);
* hymba with ``ssm_B``/``ssm_C`` cut on ``embed`` (5 heads, 7 states).

Bars (``tests/test_torch_tp_blocks.py``'s): fp32 compute, 2e-6 of each
tensor's largest magnitude (sums add in another order); bf16 compute, the
output within one bf16 rounding of the one-process output (2^-8 of the
largest magnitude), gradients within 2e-2 of theirs. Every rank's output
and input gradient bit-equal, as is the gradient of a leaf held whole.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worker as worker  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.blocks import STACKS  # noqa: E402

B, S = 2, 24
FP32_BAR, BF16_OUT_BAR, BF16_GRAD_BAR = 2e-6, 2.0 ** -8, 2e-2
THREE = {"d_model": 48, "num_heads": 3, "num_kv_heads": 3}
FIVE = {"d_model": 80, "num_heads": 5, "num_kv_heads": 5}
# (name, block kind, arch, config fields)
BLOCKS = (("mlstm-heads", "mlstm", "xlstm-125m", {}),
          ("mlstm-whole", "mlstm", "xlstm-125m", THREE),
          ("slstm-heads", "slstm", "xlstm-125m", {}),
          ("slstm-whole", "slstm", "xlstm-125m", THREE),
          ("hymba-heads", "hymba", "hymba-1.5b", {}),
          ("hymba-states", "hymba", "hymba-1.5b", FIVE),
          ("hymba-embed", "hymba", "hymba-1.5b", dict(FIVE, ssm_state=7)))
# the leaves' offsets: the reference's init constants (b_if 0 / 3, dt bias
# -2, A_log 0, D 1, scales and norms 1) plus noise
OFFSETS = {"ssm_dt_bias": -2.0, "ssm_A_log": 0.0, "ssm_D": 1.0, "scale_attn": 1.0,
           "scale_ssm": 1.0}
# the leaf whose cut sets how each block computes, and that cut on both
# worlds: heads (wq, r_gates, ssm_B), rows (the cell whole), states
MODE = {"mlstm-heads": ("wq", 1), "mlstm-whole": ("wq", 0), "slstm-heads": ("r_gates", 0),
        "slstm-whole": ("r_gates", None), "hymba-heads": ("ssm_B", 1),
        "hymba-states": ("ssm_B", 2), "hymba-embed": ("ssm_B", 0)}


def _params(kind, cfg, rng):
    out = {}
    for k, p in STACKS[kind](cfg, 1, "meta").named_parameters():
        k = k.replace(".", "/")
        shape = tuple(p.shape[1:])
        noise = rng.standard_normal(shape).astype(np.float32)
        if k == "b_if":
            base = np.repeat(np.float32([0.0, 3.0]), shape[0] // 2)
            out[k] = (base + 0.1 * noise).astype(np.float32)
        elif "norm" in k or k in OFFSETS:
            out[k] = (OFFSETS.get(k, 1.0) + 0.1 * noise).astype(np.float32)
        else:
            out[k] = 0.05 * noise
    return out


def cases():
    """The blocks in both compute types; the same list on every rank and
    here."""
    rng = np.random.default_rng(28)
    out = []
    for name, kind, arch, fields in BLOCKS:
        fields = dict(fields, gla_chunk=8)
        cfg = dataclasses.replace(reduced_config(arch), **fields)
        params = _params(kind, cfg, rng)
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        cot = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        for dtype in ("fp32", "bf16"):
            out.append({"name": name, "kind": kind, "arch": arch, "cfg": fields,
                        "params": params, "x": x, "cot": cot, "dtype": dtype})
    return out


CASES = cases()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: worker.start(n, {"blocks": {"kind": "recurrent_blocks", "cases": CASES}},
                            str(tmp_path_factory.mktemp(f"recurrent_tp{n}"))) for n in (2, 4)}


@pytest.fixture(scope="module")
def results(worlds):
    return {n: [r["blocks"] for r in worker.collect(started)] for n, started in worlds.items()}


def one_process(case):
    dtype = torch.float32 if case["dtype"] == "fp32" else torch.bfloat16
    with worker._compute_dtype(dtype):
        cfg = dataclasses.replace(reduced_config(case["arch"]), **case["cfg"])
        flat = {k: torch.from_numpy(v).clone().requires_grad_() for k, v in case["params"].items()}
        x = torch.from_numpy(case["x"]).to(dtype).requires_grad_()
        y = worker.recurrent_apply(case["kind"], flat, x, cfg)
        (y.float() * torch.from_numpy(case["cot"])).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "grads": {k: v.grad for k, v in flat.items()}}


def gaps(ranks, case):
    """Max abs difference over the largest magnitude of the output, the
    input's gradient and each leaf's gradient (the shards joined) against
    the one-process function; every rank's replicated tensors bit-equal."""
    want = one_process(case)
    rel = lambda a, b: float((a.float() - b.float()).abs().max() / b.float().abs().max())
    for r in ranks[1:]:
        assert torch.equal(r["y"], ranks[0]["y"]) and torch.equal(r["x_grad"], ranks[0]["x_grad"])
    out = {"y": rel(ranks[0]["y"], want["y"]), "x_grad": rel(ranks[0]["x_grad"], want["x_grad"])}
    cuts = worker.recurrent_cuts(case["kind"], {k: v.shape for k, v in case["params"].items()},
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
def test_block_against_one_process(results, i):
    case = CASES[i]
    for world in (2, 4):
        got, cuts = gaps([r[i] for r in results[world]], case)
        leaf, dim = MODE[case["name"]]
        assert cuts[leaf] == dim, (leaf, cuts)
        print(f"{case['name']} {case['dtype']} on {world} ranks: cuts "
              f"{ {k: d for k, d in cuts.items() if d is not None} }; {got}")
        for k, v in got.items():
            bar = (FP32_BAR if case["dtype"] == "fp32" else
                   BF16_OUT_BAR if k == "y" else BF16_GRAD_BAR)
            assert v <= bar, (k, world, got)

"""The reference checked against the program at the tiny configurations on
the CPU: its optimizer step bit for bit on every route, its loss and
gradients within the bf16 program's rounding, and a whole run correct."""

import json
from pathlib import Path

import pytest
import torch

import check
import harness
import weights
from reference import model as ref_model
from reference import optim as ref_optim

DATA = Path(__file__).resolve().parent / "data"
CONFIGS = ["tiny-dense", "tiny-moe"]


def _unpack(codes, last):
    return torch.stack([codes & 15, codes >> 4], -1).reshape(*codes.shape[:-1], -1)[..., :last]


@pytest.mark.parametrize("name", CONFIGS)
def test_optimizer_step_is_the_programs_bit_for_bit(name):
    from repro_torch.core.optimizers import linear_warmup_linear_decay, make_optimizer
    from repro_torch.core.optimizers.base import tree_order
    from repro_torch.kernels import sr

    cfg = json.loads((DATA / "configs" / f"{name}.json").read_text())
    shapes = ref_model.leaf_shapes(cfg)
    seed = 3000000019
    mine = tree_order(weights.make(shapes, seed, 0.02, "cpu"))
    ref_p = {k: v.clone() for k, v in mine.items()}
    opt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 2, 10))
    state = opt.init(mine)
    ref = ref_optim.Adam4(shapes, "cpu", lr=1e-3, warmup=2, total=10, seed=seed)
    assert {"fp32", "fused", "unfused"} <= set(ref.routes.values())
    g = torch.Generator().manual_seed(1)
    for t in range(1, 4):
        grads = {k: torch.randn(s, generator=g) * 1e-2 for k, s in shapes.items()}
        _, state = opt.update(tree_order(grads), state, mine, key=sr.fold_in(sr.PRNGKey(seed),
                                                                             t - 1))
        ref.step(ref_p, grads, t)
        for k in shapes:
            assert torch.equal(mine[k], ref_p[k]), k
    moments = check.moments(state)
    for k, s in shapes.items():
        ours, theirs = ref.state[k], moments[k]
        if ref.routes[k] in ("fp32", "raw"):
            assert torch.equal(ours["m"], theirs["m"]) and torch.equal(ours["v"], theirs["v"])
            continue
        assert torch.equal(ours["m"]["codes"], _unpack(theirs["m"].codes, s[-1]))
        assert torch.equal(ours["m"]["scales"], theirs["m"].scales[0])
        assert torch.equal(ours["v"]["codes"], _unpack(theirs["v"].codes, s[-1]))
        for a, b in zip(ours["v"]["stats"], theirs["v"].scales):
            assert torch.equal(a, b)
        norm = check.first_norms(state, 0.9)[k]
        assert norm == pytest.approx(ref.m_dequant_norm(k) / 0.1, rel=1e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_agree_with_the_program(name):
    from repro_torch.configs import cut_depth, reduced_config
    from repro_torch.models import Transformer, loss_fn, named_params

    cfg = json.loads((DATA / "configs" / f"{name}.json").read_text())
    pcfg = cut_depth(reduced_config(cfg["run"]["program_arch"]), cfg["num_hidden_layers"])
    model = Transformer(pcfg, device="cpu")
    params = named_params(model)
    weights.fill(params, 11, 0.02)
    ref_p = weights.make(ref_model.leaf_shapes(cfg), 11, 0.02, "cpu")
    for k in ref_p:
        assert torch.equal(params[k].detach(), ref_p[k])
        ref_p[k].requires_grad_(True)
    g = torch.Generator().manual_seed(2)
    tok = torch.randint(0, cfg["vocab_size"], (4, 32), generator=g)
    lab = torch.cat([tok[:, 1:], torch.full((4, 1), -1)], dim=1)
    loss, _ = loss_fn(model, {"tokens": tok, "labels": lab})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_model.loss(ref_p, cfg, tok, lab)),
                                                 rel=1e-3)
    # with its products' operands and gradients rounded to bf16, as the
    # program's are, the reference routes as the program does: every
    # gradient within 2% (in fp32 the experts' part at near ties)
    ref_loss = ref_model.loss(ref_p, cfg, tok, lab, "bf16")
    ref_loss.backward()
    for k, p in params.items():
        a, b = p.grad, ref_p[k].grad
        assert float(torch.linalg.vector_norm(a - b)) <= 0.02 * float(torch.linalg.vector_norm(b)), k


@pytest.mark.parametrize("cell", ["tiny-dense.tiny", "tiny-moe.tiny"])
def test_a_run_is_correct(cell, capsys):
    rc = harness.main(["--workload", cell, "--seed", "4000000007", "--seconds", "0.3"],
                      bench_file=DATA / "bench_cpu.json", data=DATA, device="cpu")
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"train_tokens_per_s", "peak_device_gb", "setup_s"}

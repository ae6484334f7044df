"""A run with the timed path broken underneath comes out not correct, once
for each fault a training cell can have: a step that returns its state
unchanged, and half of the batch left out (the mean over the rest). And
the control, the reference in fp8 in the program's place, reads past the
tiny cells' limits."""

import json
from pathlib import Path

import pytest

import check
import control
import harness
import traffic as traffic_lib

DATA = Path(__file__).resolve().parent / "data"
CELLS = ["tiny-dense.tiny", "tiny-moe.tiny"]


def _unchanged(build):
    def make(model, opt, *a, **k):
        from repro_torch.models import loss_fn

        def step(state, batch):
            loss, _ = loss_fn(model, batch)
            return state, {"loss": loss.detach()}

        return step

    return make


def _half_batch(build):
    def make(model, opt, *a, **k):
        real = build(model, opt, *a, **k)
        return lambda state, batch: real(state, {key: v[: v.shape[0] // 2]
                                                 for key, v in batch.items()})

    return make


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch, capsys):
    from repro_torch.train import train_loop

    monkeypatch.setattr(train_loop, "build_train_step", fault(train_loop.build_train_step))
    rc = harness.main(["--workload", cell, "--seed", "4000000007", "--seconds", "0.2"],
                      bench_file=DATA / "bench_cpu.json", data=DATA, device="cpu")
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    c = harness.Cell(cell, DATA / "bench_cpu.json", DATA)
    for seed in (21, 22, 23):
        ring = traffic_lib.ring(c.traffic, c.config["vocab_size"], seed)
        steps = c.workload["check_steps"]
        ref = check.follow(c.config, c.workload, ring, seed, "cpu", steps)
        low = check.follow(c.config, c.workload, ring, seed, "cpu", steps, rounding="fp8")
        assert not check.judge(check.gaps(low, ref), c.workload["limits"])
        half = check.follow(c.config, c.workload, ring, seed, "cpu", steps,
                            part=control.half(c.traffic))
        assert not check.judge(check.gaps(half, ref), c.workload["limits"])

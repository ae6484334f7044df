"""On the card: a tiny cell's whole run, traced, through the CUDA kernels."""

import json
from pathlib import Path

import pytest
import torch

import harness

DATA = Path(__file__).resolve().parent / "data"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-dense.tiny", "tiny-moe.tiny"])
def test_a_traced_run_on_the_card(cell, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused update is a CUDA kernel")
    rc = harness.main(["--workload", cell, "--seed", "4000000007", "--seconds", "1",
                       "--trace", "1"], bench_file=DATA / "bench_cpu.json", data=DATA)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0

"""The yardstick's frozen copies equal the program's functions at every
cell's shapes, so a drift in either shows."""

import json
from pathlib import Path

import pytest
import torch

import yardstick
from reference import model as ref_model
from reference import optim as ref_optim

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _config(cell):
    conf = {c["name"]: c for c in SPEC["configs"]}[cell["config"]]
    return json.loads((ROOT / conf["file"]).read_text())


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_frozen_copies_equal_the_programs(cell):
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.models import init_model, named_params, param_axes
    from repro_torch.roofline.analysis import model_flops
    from repro_torch.roofline.measured import b1_stats_bytes, b1_update_bytes

    cfg_file = _config(cell)
    traffic = json.loads((ROOT / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    tokens = traffic["batch"] * traffic["seq"]
    cfg = cut_depth(get_config(cfg_file["run"]["program_arch"]), cfg_file["num_hidden_layers"])
    params = named_params(init_model(cfg, device="meta"))
    shapes = ref_model.leaf_shapes(cfg_file)
    assert {k: tuple(p.shape) for k, p in params.items()} == shapes
    d = ref_model.dims(cfg_file)
    assert yardstick.model_flops_6n(shapes, d["k"], d["E"], tokens) == model_flops(
        cfg, params, param_axes(cfg), "train", tokens)
    fused = [s for k, s in shapes.items() if ref_optim.route(k, s) == "fused"]
    assert fused
    for s in fused:
        L, R, C = int(torch.tensor(s[:-2]).prod()) if len(s) > 2 else 1, s[-2], s[-1]
        assert yardstick.b1_update_bytes(L, R, C) == b1_update_bytes(L, R, C)
        assert yardstick.b1_stats_bytes(L, R, C) == b1_stats_bytes(L, R, C)


def test_attention_flops_by_hand():
    # one layer, one head of 128, one row of 4: 3 x (2 products x 2 B S^2 H dh) / 2
    assert yardstick.attention_flops(1, 1, 128, 1, 4) == 3 * 2 * 2 * 16 * 128 / 2


def test_update_least_bytes():
    # an fp32 leaf of 10 elements: g, p read, p written (120 B); m, v read and written (160 B)
    assert yardstick.update_least_bytes([(40, [40, 40])]) == 280

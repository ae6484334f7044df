"""The port's dry run over whole archs (``repro_torch.launch.dryrun``):
``run_all`` over xlstm-125m and internlm2-1.8b on the single-pod plan writes
8 records (1 skipped, none in error), a second call adds none, and the CLI
prints one record equal to ``run_all``'s (moved out of
``tests/test_torch_dryrun.py``: the longest test of the port's files).

Also here, with ``tests/test_torch_roofline.py``'s helpers: the
roofline's terms, the H100 card, the recorder against the HLO parse and
when closed, a dense layer's FLOPs and ``measure`` on a mesh."""

import json

import pytest

torch = pytest.importorskip("torch")

from repro.roofline import analysis as j_analysis  # noqa: E402
from repro_torch.comms.collectives import all_gather, Ranks, recording, without_world  # noqa: E402
from repro_torch.configs import reduced_config, ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import plan_scan_units  # noqa: E402
from repro_torch.models.layers import COMPUTE_DTYPE  # noqa: E402
from repro_torch.roofline import analysis, measured  # noqa: E402
from test_roofline import SAMPLE_HLO  # noqa: E402
from test_torch_roofline import _reckon, MESH_ARCH  # noqa: E402


def test_run_all_is_resumable_and_the_cli_prints_a_record(tmp_path, capsys):
    out = str(tmp_path / "d.json")
    archs = ["xlstm-125m", "internlm2-1.8b"]
    recs = dryrun.run_all(out, meshes=("single",), archs=archs)
    assert len(recs) == 8
    status = [r["status"] for r in recs]
    assert status.count("skipped") == 1 and "error" not in status, recs
    assert [r for r in recs if r["status"] == "skipped"][0]["arch"] == "internlm2-1.8b"
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(recs))
    assert dryrun.run_all(out, meshes=("single",), archs=archs) == json.loads(json.dumps(recs))
    capsys.readouterr()
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "train_4k", "--mesh", "single"])
    rec = json.loads(capsys.readouterr().out)
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["status"]) == (
        "internlm2-1.8b", "train_4k", "single", "ok")
    train = [r for r in recs if (r["arch"], r["shape"]) == ("internlm2-1.8b", "train_4k")][0]
    assert rec["memory"] == train["memory"] and rec["roofline"] == train["roofline"]


@pytest.mark.parametrize("bottleneck,cost,coll", [
    ("compute", {"flops": 2e15, "bytes accessed": 1e12}, 1e9),
    ("memory", {"flops": 1e14, "bytes accessed": 7e12}, 2e10),
    ("collective", {"flops": 1e13, "bytes accessed": 1e11}, 5e12),
])
def test_roofline_terms_equal_reference(bottleneck, cost, coll):
    hw = analysis.H100
    ref_hw = j_analysis.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw, link_bw=hw.link_bw)
    got = analysis.roofline_terms(cost, coll, 256, 3e15, hw)
    want = j_analysis.roofline_terms(cost, coll, 256, 3e15, ref_hw)
    assert got.as_dict() == want.as_dict()
    assert got.bottleneck == bottleneck


def test_h100_is_the_default_and_only_card():
    assert analysis.roofline_terms({"flops": 1.0}, 0.0, 1, 1.0).compute_s == 1.0 / 989.4e12
    assert analysis.hw_for_card("NVIDIA H100 80GB HBM3") is analysis.H100
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        with pytest.raises(ValueError, match="no roofline constants"):
            analysis.hw_for_card(name)


@pytest.mark.parametrize("multiplier", [1.0, 3.0])
def test_recorder_equals_hlo_parse(multiplier):
    want = j_analysis.collective_bytes_from_hlo(SAMPLE_HLO, multiplier=multiplier)
    with without_world(16), recording() as calls:
        # bf16[16,4096] gathered over groups of 4: each rank's (4, 4096)
        out = all_gather(torch.empty((4, 4096), dtype=torch.bfloat16, device="meta"),
                         Ranks(range(4)))
    assert tuple(out.shape) == (4, 4, 4096)
    assert calls == [("all-gather", 16 * 4096 * 2, 4)]
    calls = [("all-reduce", 1024 * 512 * 4, 8),    # f32[1024,512], replica_groups=[2,8]
             *calls,
             ("reduce-scatter", 64 * 4, 4),        # f32[64], {{0,1,2,3}}
             ("collective-permute", 128 * 2, 1)]   # bf16[128], no groups
    assert analysis.collective_bytes(calls, multiplier) == want


def test_recorder_costs_nothing_when_closed():
    with without_world(4):
        all_gather(torch.empty(8, device="meta"))  # no recording open: nothing kept
        with recording() as calls:
            all_gather(torch.empty(8, device="meta"))
    assert calls == [("all-gather", 4 * 8 * 4, 4)]
    rec = analysis.collective_bytes(calls)
    assert rec["ops"] == 1.0 and rec["all-gather"] == 3 / 4 * 4 * 8 * 4


@pytest.mark.parametrize("train", [True, False])
def test_dense_layer_flops_are_2mnk(train):
    cfg = reduced_config("internlm2-1.8b")
    B, S, D, F = 2, 64, cfg.d_model, cfg.d_ff
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    unit = plan_scan_units(cfg.blocks)[0]
    dtype = torch.float32 if train else COMPUTE_DTYPE
    pos = torch.arange(S, device="meta")[None].expand(B, S)
    c = measured._seq_probe(cfg, unit, "decoder", B, S, pos, train, dtype)
    mm = lambda m, n, k: 2 * m * n * k
    bf16 = (mm(B * S, H * hd, D) + 2 * mm(B * S, Hkv * hd, D) + mm(B * S, D, H * hd)
            + 3 * mm(B * S, F, D))               # w1, w3, w2
    fp32 = 2 * B * H * mm(S, S, hd)              # q.k over the one (64, 64) pair, then p.v
    k = 3 if train else 1                        # backward: both operands' gradients
    # the attention pair's forward runs again in the backward (its recompute)
    assert c.flops_by_dtype == {"bfloat16": k * bf16, "float32": (k + train) * fp32}
    # the fp32 products run off the tensor cores: priced at the card's fp32 rate
    hw = analysis.H100
    terms = analysis.roofline_terms({"flops": c.flops, "flops by dtype": c.flops_by_dtype},
                                    0.0, 1, 1.0, hw)
    assert terms.compute_s == k * bf16 / 989.4e12 + (k + train) * fp32 / 67e12
    assert terms.compute_s > c.flops / hw.peak_flops


def test_measure_on_a_mesh_records_the_reckoning():
    cfg = reduced_config(MESH_ARCH)
    shape = ShapeSpec("small", 32, 8, "train")
    rec = measured.measure(cfg, shape, {"data": 2, "model": 2}, optimizer="production4bit")
    result_bytes, calls = _reckon((2, 2), 0)[0]
    link = analysis.collective_bytes(calls)
    assert rec["collectives"]["result_bytes"] == result_bytes
    assert {k: rec["collectives"][k] for k in link} == link
    assert rec["rank_batch"] == 4 and rec["n_chips"] == 4
    assert rec["roofline"]["collective_bytes"] == link["total"]
    one = measured.measure(cfg, shape, optimizer="production4bit")
    # data- and model-split compute: a rank of 2 data shards computes half the
    # batch on half the heads, mlp columns and vocab rows: a quarter of the
    # one-device products (every product of the arch is split)
    assert rec["compute_split"] == "data+model"
    assert rec["roofline"]["flops"] * 4 == one["roofline"]["flops"]
    assert rec["row_tile_leaves"] == []

"""``BENCHMARK.json`` and the files it names: every file parses, every name
it gives has its file, and the contract's limits on names, counts and the
run length hold."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
NOT_CUT = ("num_experts_per_tok", "num_local_experts")  # widths, and the experts held
CHECKS = {"loss_gap", "grad_gap", "change_gap", "grad_gap_median", "change_gap_median"}


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    # a full check of 24 cells (2 + 14 runs a cell of run_seconds + 60 s, 180 s a cell to
    # compile, 1,200 s spare) fits in 43,200 s
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert NAME.match(conf["name"]) and conf["file"].startswith("bench/configs/")
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]
    for key in conf["reduced"]:
        assert NAME.match(key) and key in cfg
        assert key not in NOT_CUT and not key.endswith(("_size", "_dim", "_rank", "_factor"))
    # the program's fixed departures override published keys, and no width
    for key, value in cfg.get("departures", {}).items():
        assert key in cfg and cfg[key] != value and key not in conf["reduced"]
        assert key not in NOT_CUT and not key.endswith(("_size", "_dim", "_rank", "_factor"))


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    assert traffic["kind"] == "synthetic_lm" and traffic["ring"] >= 3
    work = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    assert set(work["limits"]) <= CHECKS and work["limits"]
    assert work["check_steps"] <= traffic["ring"]


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert {"train_tokens_per_s", "peak_device_gb", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {c["name"] for c in SPEC["workloads"]}
    names = set()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert m["name"].split(".")[0] in ("train_tokens_per_s", "peak_device_gb", "setup_s")
    for cell in cells:  # setup_s, one more end-to-end metric and one per-layer metric
        mine = lambda m: cell in m.get("workloads", cells)
        assert "setup_s" in e2e and mine(e2e["setup_s"])
        assert sum(mine(m) for m in SPEC["end_to_end"]) >= 2
        assert any(mine(m) for m in SPEC["per_layer"])
    for m in SPEC["per_layer"]:
        readers = (BENCH / "metrics" / f"{m['name']}.py", BENCH / "metrics" /
                   f"{m['name'].split('.')[0]}.py")
        assert m["moves"] in e2e and any(r.is_file() for r in readers)
        # every cell the metric names reports the end-to-end metric it moves
        assert set(m.get("workloads", cells)) <= set(e2e[m["moves"]].get("workloads", cells))
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_size():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_runs_the_programs_config(cell):
    """The configuration as run (the file with its departures) is the one the
    program builds: ``port_config`` raises where a size or rope theta differs."""
    import harness

    c = harness.Cell(cell["name"], ROOT / "BENCHMARK.json")
    conf = {x["name"]: x for x in SPEC["configs"]}[cell["config"]]
    published = json.loads((ROOT / conf["file"]).read_text())
    for key, value in published.get("departures", {}).items():
        assert c.config[key] == value
    assert harness.port_config(c).num_layers == published["num_hidden_layers"]

"""The trace reduction and the per-layer readers on a small canned record."""

import importlib.util
from pathlib import Path

import pytest

import devtrace
import yardstick

BENCH = Path(__file__).resolve().parents[1]

# window 0-100 us; kernels at 10-30 and 20-40 (overlapping) and 60-70;
# the host runs "aten::mm" over 40-60 and "py_step" over everything
CANNED = {"traceEvents": [
    {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 0, "dur": 100},
    {"ph": "X", "cat": "cpu_op", "name": "py_step", "ts": 0, "dur": 100},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 40, "dur": 20},
    {"ph": "X", "cat": "kernel", "name": "void fused_adamw4_kernel<true>(...)", "ts": 10,
     "dur": 20},
    {"ph": "X", "cat": "kernel", "name": "rank1_stats_kernel", "ts": 20, "dur": 20},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60, "dur": 10},
    {"ph": "i", "cat": "cpu_instant_event", "name": "ignored", "ts": 5},
]}


def _read(name, run):
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def test_summary():
    s = devtrace.summary(devtrace.records(CANNED))
    assert s["window_s"] == pytest.approx(100e-6) and s["busy_s"] == pytest.approx(40e-6)
    assert s["device_ops"][0][0].startswith("void fused_adamw4_kernel")
    gaps = dict(s["idle_gaps"])  # 0-10 and 70-100 under py_step, 40-60 under aten::mm
    assert gaps["py_step"] == pytest.approx(40e-6) and gaps["aten::mm"] == pytest.approx(20e-6)
    assert devtrace.seconds_of(s["device_s"], yardstick.B1_KERNELS) == pytest.approx(40e-6)


def test_readers():
    trace = devtrace.summary(devtrace.records(CANNED))
    trace["b1_launches"] = [("fused_adamw4", (1, 128, 256)), ("rank1_new_stats", (1, 128, 256))]
    run = {"steps": 4, "window_s": 2.0, "tokens_per_step": 100, "flops_per_step": 989.4e12,
           "model_ms": 400.0, "optimizer_ms": 200.0, "trace": trace,
           "opt_state_bytes": 2.5e9, "update_least_bytes": 3.35e9}
    assert _read("mfu", run) == pytest.approx(200.0)
    assert _read("device_idle_pct", run) == pytest.approx(60.0)
    assert _read("model_ms", run) == pytest.approx(100.0)
    assert _read("optimizer_ms", run) == pytest.approx(50.0)
    assert _read("opt_state_gb", run) == pytest.approx(2.5)
    assert _read("update_roofline", run) == pytest.approx(100.0 * 1e-3 / 50e-3)
    least = yardstick.b1_update_bytes(1, 128, 256) + yardstick.b1_stats_bytes(1, 128, 256)
    assert _read("b1_roofline", run) == pytest.approx(100.0 * least / 3.35e12 / 40e-6)
    trace["b1_launches"] = []
    assert _read("b1_roofline", run) is None


def test_a_split_name_reads_as_its_quantity():
    import harness

    run = {"steps": 2, "optimizer_ms": 30.0}
    assert harness._reader("optimizer_ms.long")(run) == harness._reader("optimizer_ms")(run) == 15.0

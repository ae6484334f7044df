"""One run of one cell of the port's training benchmark.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

1. Set-up: the cell's entry in ``BENCHMARK.json`` names its configuration
   (``configs/``), traffic (``traffic/``) and settings (``workloads/``).
   The program's model is built from its arch at the file's depth, its
   weights made on the device from the seed (``weights``), its optimizer
   state made by ``make_train_state``, and its step by ``build_train_step``,
   the step the training CLI runs. A ring of distinct batches is made from
   the seed (``traffic``) and put on the device. The first ``check_steps``
   steps go through that step on the ring's first batches; they warm up
   every shape, and the readings that decide ``correct`` are taken from
   them (``check``).
2. The window: steps dispatched back to back for ``--seconds``, the losses
   left on the device; then one synchronise. The process keeps torch's
   threads and Python's collector as they come, as the training CLI's
   one-process run does. The rate is every token of the
   window's steps over the time from the window's start to that
   synchronise.
3. ``--trace 1``: the window's steps carry CUDA events (the step's call, the
   optimizer update's start and end); then ``trace_steps`` more steps run
   under ``torch.profiler``, and each per-layer metric's reader
   (``metrics/<name>.py``) takes its number from the window, the events, the
   trace or the state.
4. The peak memory is read, the program's state freed, and the reference
   follows the checked steps from the same weights and batches; the three
   gaps (``check``) are printed beside their limits on standard error and
   as the result line's last key.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (window steps), ``failed`` (those with a loss that is not
finite), ``metrics``, ``device`` and, traced, ``breakdown``, then
``checks``.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

import check
import devtrace
import traffic as traffic_lib
import weights
import yardstick
from reference import model as ref_model

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Cell:
    """A cell's entry with its configuration, traffic, settings and the
    metrics ``BENCHMARK.json`` gives it."""

    def __init__(self, name: str, bench_file: Path, data: Path = BENCH):
        root = bench_file.parent
        bench = json.loads(bench_file.read_text())
        entry = {w["name"]: w for w in bench["workloads"]}.get(name)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in {bench_file.name}; "
                             f"it has {sorted(w['name'] for w in bench['workloads'])}")
        self.name, self.chips = name, entry["chips"]
        conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
        # the published configuration, with the program's fixed departures from it
        published = json.loads((root / conf["file"]).read_text())
        self.config = {**published, **published.get("departures", {})}
        self.traffic = json.loads((data / "traffic" / f"{entry['traffic']}.json").read_text())
        self.workload = json.loads((data / "workloads" / f"{name}.json").read_text())
        mine = lambda m: name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    @property
    def tokens_per_step(self) -> int:
        return self.traffic["batch"] * self.traffic["seq"]


class UpdateTimer:
    """Wraps an optimizer's update with CUDA events while ``on``."""

    def __init__(self):
        self.on = False
        self.pairs: List[tuple] = []

    def wrap(self, update):
        def timed(*a, **k):
            if not self.on:
                return update(*a, **k)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = update(*a, **k)
            e1.record()
            self.pairs.append((e0, e1))
            return out

        return timed


def port_config(cell: Cell):
    """The program's ``ModelConfig`` for the cell: its arch cut to the file's
    depth, checked against every size the file states."""
    from repro_torch.configs import cut_depth, get_config, reduced_config

    c = cell.config
    arch = c["run"]["program_arch"]
    cfg = reduced_config(arch) if c["run"].get("program_reduced") else get_config(arch)
    if cfg.num_layers != c["num_hidden_layers"]:
        cfg = cut_depth(cfg, c["num_hidden_layers"])
    d = ref_model.dims(c)
    want = dict(d_model=d["D"], num_heads=d["H"], num_kv_heads=d["Hkv"], head_dim=d["dh"],
                d_ff=d["F"], vocab_size=d["V"], num_layers=d["L"], num_experts=d["E"],
                top_k=d["k"], rope_theta=float(c["rope_theta"]),
                moe_group_size=c.get("moe_group_size", cfg.moe_group_size),
                tie_embeddings=c["tie_word_embeddings"])
    have = {k: getattr(cfg, k) for k in want}
    if have != want:
        raise ValueError(f"{cell.config['name']}: the program's config {have} is not the "
                         f"file's {want}")
    return cfg


class Program:
    """The system under test: model, optimizer state and train step."""

    def __init__(self, cell: Cell, seed: int, device):
        from repro_torch.core.optimizers import linear_warmup_linear_decay, make_optimizer
        from repro_torch.core.optimizers.base import Optimizer
        from repro_torch.kernels import sr
        from repro_torch.models import Transformer, named_params
        from repro_torch.train.train_loop import build_train_step, make_train_state

        w = cell.workload
        self.cfg = port_config(cell)
        self.model = Transformer(self.cfg, device=device)
        params = named_params(self.model)
        shapes = {k: tuple(p.shape) for k, p in params.items()}
        if shapes != ref_model.leaf_shapes(cell.config):
            raise ValueError(f"the program's leaves {shapes} are not the configuration's")
        weights.fill(params, seed, cell.config["initializer_range"])
        opt = make_optimizer(w["optimizer"], linear_warmup_linear_decay(
            w["lr"], w["warmup"], w["total_steps"]))
        self.timer = UpdateTimer()
        opt = Optimizer(opt.init, self.timer.wrap(opt.update), opt.name)
        self.state = make_train_state(self.model, opt, key=sr.PRNGKey(seed))
        self.step_fn = build_train_step(self.model, opt)
        self.starts: List[torch.cuda.Event] = []

    def step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.timer.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.starts.append(e)
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics["loss"]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reader(name: str):
    """``metrics/<name>.py``'s ``read``; a split name (``mfu.long``) without a
    file of its own reads as its quantity does (``metrics/mfu.py``)."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "not read"


def _profile(prog: Program, batches, first: int, n: int, device) -> dict:
    """``n`` steps under ``torch.profiler`` (one more before, unannotated,
    to start it up): the trace's summary and the fused passes' launches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import adamw4bit

    launches = []
    heard = lambda name, dims: launches.append((name, tuple(dims)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prog.step(batches[first % len(batches)])
        _sync(device)
        adamw4bit.LISTENERS.append(heard)
        try:
            with record_function(devtrace.WINDOW):
                for i in range(1, n + 1):
                    prog.step(batches[(first + i) % len(batches)])
                _sync(device)
        finally:
            adamw4bit.LISTENERS.remove(heard)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            rec = devtrace.records(json.load(f))
    finally:
        os.remove(path)
    out = devtrace.summary(rec)
    out["b1_launches"] = launches
    return out


def _per_layer(cell: Cell, prog: Program, batches, first: int, n: int, window_s: float,
               device):
    """The per-layer metrics of a traced run, the breakdown and the device
    times, from the window's events, a profiled stretch and the state."""
    pairs, starts = prog.timer.pairs, prog.starts
    if len(pairs) != n or len(starts) != n:
        raise RuntimeError(f"{n} window steps, {len(starts)} step events, {len(pairs)} updates")
    step_ms = [a.elapsed_time(b) for a, b in zip(starts, starts[1:])]
    print(f"traced window: {n} steps, step ms median {float(np.median(step_ms))!r} "
          f"max {max(step_ms)!r}; launches {_launches()}; steps ms "
          f"{[round(x, 2) for x in step_ms]}", file=sys.stderr)
    prof = _profile(prog, batches, first, cell.workload["trace_steps"], device)
    moments = check.moments(prog.state.opt_state)
    leaves = [(p.numel() * p.element_size(),
               [check.tensor_bytes(moments[k]["m"]), check.tensor_bytes(moments[k]["v"])])
              for k, p in prog.state.params.items()]
    d = ref_model.dims(cell.config)
    shapes = {k: tuple(p.shape) for k, p in prog.state.params.items()}
    context = {
        "steps": n, "window_s": window_s, "tokens_per_step": cell.tokens_per_step,
        "flops_per_step": (yardstick.model_flops_6n(shapes, d["k"], d["E"], cell.tokens_per_step)
                           + yardstick.attention_flops(d["L"], d["H"], d["dh"],
                                                       cell.traffic["batch"],
                                                       cell.traffic["seq"])),
        "model_ms": sum(s.elapsed_time(u0) for s, (u0, _) in zip(starts, pairs)),
        "optimizer_ms": sum(u0.elapsed_time(u1) for u0, u1 in pairs),
        "trace": prof,
        "opt_state_bytes": check.tensor_bytes(prog.state.opt_state),
        "update_least_bytes": yardstick.update_least_bytes(leaves),
    }
    metrics = {}
    for m in cell.per_layer:
        value = _reader(m["name"])(context)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return (metrics, {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]},
            {"busy_s": prof["busy_s"], "window_s": prof["window_s"]})


def checked_steps(cell: Cell, prog: Program, batches, seed: int, device, marks=None) -> dict:
    """The cell's checked steps through the window's call on the ring's
    first batches, and the program's readings of them (``check``): the
    losses (on the device), the first gradient from the state after step 1
    and each leaf's change after the last."""
    w = cell.workload
    out = {"losses": [], "first": {}, "change": {}}
    for t in range(w["check_steps"]):
        out["losses"].append(prog.step(batches[t]))
        if t == 0:
            out["first"] = check.first_norms(prog.state.opt_state, w["b1"])
    _sync(device)
    if marks is not None:
        marks.append(("checked steps", time.perf_counter()))
    params = prog.state.params
    out["change"] = {k: weights.change_norm(k, p.detach(), params, seed,
                                            cell.config["initializer_range"])
                     for k, p in params.items()}
    if marks is not None:
        marks.append(("readings", time.perf_counter()))
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    w = cell.workload
    k_check = w["check_steps"]
    marks = [("start", t_start), ("imports", time.perf_counter())]
    ring = traffic_lib.ring(cell.traffic, cell.config["vocab_size"], seed)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in ring]
    marks.append(("batches", time.perf_counter()))
    prog = Program(cell, seed, device)
    _sync(device)
    marks.append(("program", time.perf_counter()))

    prog_read = checked_steps(cell, prog, batches, seed, device, marks)
    print("set-up s: " + ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b)
                                   in zip(marks, marks[1:])), file=sys.stderr)

    # the window
    prog.timer.on = trace
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    window = []
    i = k_check
    while time.perf_counter() - t0 < seconds:
        window.append(prog.step(batches[i % len(batches)]))
        i += 1
    _sync(device)
    window_s = time.perf_counter() - t0
    prog.timer.on = False
    n = len(window)
    losses = torch.stack(window).float()
    failed = int((~torch.isfinite(losses)).sum())

    metrics: Dict[str, dict] = {}
    breakdown = None
    extra: Dict[str, object] = {}
    if trace:
        metrics, breakdown, extra = _per_layer(cell, prog, batches, i, n, window_s, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if not trace:
        # the end-to-end quantities, by the part of a metric's name before a dot
        e2e = {"train_tokens_per_s": n * cell.tokens_per_step / window_s,
               "peak_device_gb": peak / 1e9, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
    prog_read["losses"] = [float(x) for x in prog_read["losses"]]
    print(f"window: {n} steps in {window_s!r} s ({failed} failed); set-up {setup_s!r} s; "
          f"peak {peak} B; card {_power_limit() if device.type == 'cuda' else device}",
          file=sys.stderr)

    # the program's state goes before the reference runs
    del prog, window, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_read = check.follow(cell.config, w, ring, seed, device, k_check)
    found = check.gaps(prog_read, ref_read)
    correct = check.judge(found, w["limits"])
    print(f"reference: {k_check} steps in {time.perf_counter() - t_ref!r} s; losses program "
          f"{prog_read['losses']} reference {ref_read['losses']}", file=sys.stderr)
    checks = {name: {"value": found[name]["value"], "limit": limit}
              for name, limit in w["limits"].items()}
    for name in check.NAMES:
        limit = w["limits"].get(name)
        print(f"check {name} = {found[name]['value']!r} "
              f"({'not compared' if limit is None else f'limit {limit!r}'}; "
              f"at {found[name]['at']})", file=sys.stderr)
    result = {"correct": correct, "attempted": n, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                  else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": peak, **extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _launches() -> Dict[str, int]:
    from repro_torch.kernels import adamw4bit, quant4

    return {**adamw4bit.LAUNCHES, **quant4.LAUNCHES}


def parse_args(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, *, t_start: Optional[float] = None,
         bench_file: Optional[Path] = None, data: Path = BENCH, device: str = "cuda") -> int:
    """Run one cell; 0 after printing a result, else an error code and no
    result. Tests pass their own ``bench_file`` and ``data`` folder (of
    ``traffic/`` and ``workloads/``), and ``device="cpu"``, which skips the
    look for a card."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    cell = Cell(args.workload, bench_file or BENCH.parent / "BENCHMARK.json", data)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    result = run(cell, args.seed, args.seconds, bool(args.trace), dev, t_start)
    found = _forbidden_modules()
    if found:
        print(f"the run loaded modules it must not: {found}", file=sys.stderr)
        return 3
    checks = result["checks"]
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

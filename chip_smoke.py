"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each failing the run on error:

1. print the card's name and power limit; build the port's CUDA kernel
   from ``src/repro_torch/csrc`` into ``build/kernels``;
2. hold the fused 4-bit AdamW kernel against its plain torch version on the
   card, round-to-nearest and stochastic rounding, through the leaf prepass
   at every shape the main path gives it: ``wo`` (24, 16, 128, 2048), ``w1``
   and ``w3`` (24, 2048, 8192), ``w2`` (24, 8192, 2048). Codes and scales
   must be bit-equal, params within 1e-6 relative (both round every
   operation alike). Then time kernel and plain version at each shape with
   CUDA events (median), and sum the four leaves of one step;
3. check the card against the CPU on a small input: three reduced-config
   production4bit steps from the same weights. Losses must agree within
   3e-4 relative (measured gap 3.2e-5: bf16 products round differently),
   a gap that the same model without its optimizer steps must exceed five
   times over, and at least 90% of the fused leaves' 4-bit first-moment
   codes must agree;
4. drive the main path: ``repro_torch.launch.train`` trains internlm2-1.8b
   at full width and depth, production4bit with SR, 5 steps of batch 8 x seq
   128, with every kernel launch count set to 0 just before and read just
   after; check state bytes (4,590,578,552), 4 launches per step, finite
   losses and a last loss below the first;
5. split one more full-size step into model and optimizer time (CUDA
   events) and list its top device kernels (``torch.profiler``).

Prints the kernel table as a JSON line, then the device line as the last
line. Needs a CUDA card and the repository beside it; without either it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
STATE_BYTES_INTERNLM2 = 4_590_578_552
STEPS = 5
# the fused leaves of internlm2-1.8b: (names, shape, leaves of that shape)
LEAF_SHAPES = (("wo", (24, 16, 128, 2048), 1), ("w1,w3", (24, 2048, 8192), 2),
               ("w2", (24, 8192, 2048), 1))
SMALL_RTOL = 3e-4
OUT_DIR = ROOT / "chiprun_out"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_build():
    from repro_torch.kernels import adamw4bit

    t0 = time.perf_counter()
    lib = adamw4bit.build_library()
    print(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")


def _states(shape, sr_on, seed, dev):
    import dataclasses

    import torch

    from repro_torch.core.optimizers.adamw import M_4BIT, V_4BIT
    from repro_torch.core.quantizer import quantize

    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(shape, generator=g, device=dev)
    grad = torch.randn(shape, generator=g, device=dev) * 1e-2
    m0 = torch.randn(shape, generator=g, device=dev) * 1e-3
    v0 = torch.randn(shape, generator=g, device=dev).abs() * 1e-5 + 1e-12
    mc = dataclasses.replace(M_4BIT, stochastic_rounding=sr_on)
    vc = dataclasses.replace(V_4BIT, stochastic_rounding=sr_on)
    return w, grad, quantize(m0, mc), quantize(v0, vc)


HP = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
SCAL = dict(lr=1e-3, bc1=0.271, bc2=0.002997)  # step 3 of the default betas


def _compare(shape, k_out, p_out, sr_on):
    """Kernel output against plain output; returns max |dw|."""
    import torch

    for name, a, b in zip(("m codes", "m scales", "v codes"), k_out[1:], p_out[1:]):
        if not torch.equal(a, b):
            diff = (a.to(torch.float64) - b.to(torch.float64)).abs()
            fail(f"{shape} sr={sr_on}: {name} differ at {int((diff > 0).sum())} "
                 f"places (max {float(diff.max())})")
    err = float((k_out[0] - p_out[0]).abs().max())
    if not torch.allclose(k_out[0], p_out[0], rtol=1e-6, atol=0.0):
        fail(f"{shape} sr={sr_on}: params differ (max abs {err})")
    return err


def _median_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _bound(shape):
    """Least time for one launch on a leaf of ``shape`` (the kernel sees
    (L, R, C), leading dims folded into L): each input read once, each
    output written once, against fp32 operations."""
    R, C = shape[-2], shape[-1]
    n = math.prod(shape)
    L = n // (R * C)
    read = n * (4 + 4 + 0.5 + 0.5) + n / 128 * 4 + (2 * L * R + 2 * C) * 4 + L * 2 * 4
    write = n * (4 + 0.5 + 0.5) + n / 128 * 4
    nbytes = read + write
    flops = 30.0 * n  # dequant, Eq. 1, absmax, two normalisations
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def phase_leaves(dev):
    """Kernel against plain version at every fused leaf shape of the main
    path, RTN and SR, on identical operands; then both timed (SR, the main
    path's mode: kernel median of 21, plain median of 3; RTN kernel too)."""
    import torch

    from repro_torch.kernels import adamw4bit, ops, sr

    rows, max_err = [], 0.0
    for names, shape, count in LEAF_SHAPES:
        row = dict(leaves=names, shape=list(shape), count=count)
        for sr_on in (False, True):
            w, grad, m_q, v_q = _states(shape, sr_on, 1, dev)
            key = sr.PRNGKey(0) if sr_on else None
            operands, _ = ops.leaf_operands(w, grad, m_q, v_q, HP["b2"], key)
            k_out = adamw4bit.fused_adamw4(**operands, **SCAL, **HP)
            p_out = adamw4bit.fused_adamw4_plain(**operands, **SCAL, **HP)
            torch.cuda.synchronize()
            err = _compare(shape, k_out, p_out, sr_on)
            max_err = max(max_err, err)
            print(f"fused_adamw4 {names} {shape} sr={sr_on}: codes and scales bit-equal, "
                  f"max |dw| = {err:.3g}")
            del k_out, p_out
            kernel = lambda: adamw4bit.fused_adamw4(**operands, **SCAL, **HP, out=operands["w"])
            for _ in range(3):
                kernel()
            row["sr_ms" if sr_on else "rtn_ms"] = _median_ms(kernel, 21)
            if sr_on:
                row["plain_ms"] = _median_ms(
                    lambda: adamw4bit.fused_adamw4_plain(**operands, **SCAL, **HP), 3)
            del w, grad, m_q, v_q, operands
            torch.cuda.empty_cache()
        row["bound_ms"], row["bound_by"], row["bytes"] = _bound(shape)
        gbs = row["bytes"] / (row["sr_ms"] * 1e-3) / 1e9
        print(f"fused_adamw4 {names} {shape} x{count}: SR kernel {row['sr_ms']:.4f} ms "
              f"({gbs:.0f} GB/s, {gbs * 1e9 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s), "
              f"RTN kernel {row['rtn_ms']:.4f} ms, plain {row['plain_ms']:.1f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows.append(row)
    step = {k: sum(r[k] * r["count"] for r in rows)
            for k in ("sr_ms", "rtn_ms", "plain_ms", "bound_ms", "bytes")}
    step["bound_by"] = "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations"
    print(f"fused_adamw4 per step (4 leaves, SR): kernel {step['sr_ms']:.4f} ms, "
          f"RTN kernel {step['rtn_ms']:.4f} ms, plain {step['plain_ms']:.1f} ms, "
          f"bound {step['bound_ms']:.4f} ms ({step['bytes'] / 1e9:.2f} GB)")
    return max_err, rows, step


def phase_small_reference(dev):
    """Three reduced-config production4bit SR steps from the same weights
    on the card and on the CPU (the CPU runs the plain version)."""
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.convert import load_params
    from repro_torch.core.optimizers import linear_warmup_linear_decay, make_optimizer
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sr
    from repro_torch.models import init_model, loss_fn, named_params
    from repro_torch.train.train_loop import build_train_step, make_train_state

    cfg = reduced_config("internlm2-1.8b")
    cpu_model = init_model(cfg, seed=0, device="cpu")
    dev_model = init_model(cfg, device="meta").to_empty(device=dev)
    load_params(dev_model, {k: p.detach() for k, p in named_params(cpu_model).items()})
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4))
    cpu_batch = lambda t: {k: torch.from_numpy(v) for k, v in data.batch_at(t).items()}
    with torch.no_grad():  # the same model with no optimizer steps
        still = [float(loss_fn(cpu_model, cpu_batch(t))[0]) for t in range(3)]
    losses, m_codes = {}, {}
    for name, model, d in (("card", dev_model, dev), ("cpu", cpu_model, torch.device("cpu"))):
        opt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 1, 3))
        state = make_train_state(model, opt, key=sr.PRNGKey(0))
        step = build_train_step(model, opt)
        losses[name] = []
        for t in range(3):
            state, metrics = step(state, {k: v.to(d) for k, v in cpu_batch(t).items()})
            losses[name].append(float(metrics["loss"]))
        m = state.opt_state.states["4bit"].states[0].inner.m
        m_codes[name] = [m[f"decoder/0/sub0/mlp/{w}"].codes.cpu() & 0xF for w in ("w1", "w2", "w3")]
    card, cpu = losses["card"], losses["cpu"]
    print("reduced production4bit, card / CPU / without steps losses: "
          + ", ".join(f"{a:.6f}/{b:.6f}/{c:.6f}" for a, b, c in zip(card, cpu, still)))
    for a, b in zip(card, cpu):
        if not (math.isfinite(a) and abs(a - b) <= SMALL_RTOL * abs(b)):
            fail(f"reduced run: card losses {card} vs CPU {cpu} (rtol {SMALL_RTOL})")
    if not abs(still[-1] - cpu[-1]) > 5 * SMALL_RTOL * abs(cpu[-1]):
        fail(f"reduced run: the steps moved the loss too little to test ({still} vs {cpu})")
    agree = [float((a == b).float().mean()) for a, b in zip(m_codes["card"], m_codes["cpu"])]
    print(f"reduced production4bit, card vs CPU 4-bit m code agreement (w1, w2, w3): {agree}")
    if min(agree) < 0.9:
        fail(f"reduced run: 4-bit m codes agree at {agree}")
    return dict(card=card, cpu=cpu, without_steps=still, m_code_agreement=agree)


def phase_main_path(launches):
    import torch

    from repro_torch.launch import train

    for k in launches:
        launches[k] = 0
    out = train.main(["--arch", "internlm2-1.8b", "--optimizer", "production4bit",
                      "--sr-seed", "0", "--steps", str(STEPS), "--batch", "8", "--seq", "128",
                      "--device", "cuda"])
    counts = dict(launches)
    losses = [r["loss"] for r in out["steps"]]
    for r in out["steps"]:
        print(f"main path step {r['step']}: loss {r['loss']:.4f}  {r['ms']:.1f} ms  "
              f"grad_norm {r['grad_norm']:.3f}")
    print(f"main path: params {out['n_params']:,}  state_bytes {out['state_bytes']:,}  "
          f"peak device memory {out['peak_bytes'] / 1e9:.2f} GB  launches {counts}")
    if out["state_bytes"] != STATE_BYTES_INTERNLM2:
        fail(f"state_bytes {out['state_bytes']} != {STATE_BYTES_INTERNLM2}")
    if counts["fused_adamw4"] != 4 * STEPS:
        fail(f"fused_adamw4 launched {counts['fused_adamw4']} times, expected {4 * STEPS}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses}")
    del out
    torch.cuda.empty_cache()
    return counts, losses


def phase_profile(dev):
    """Where one full-size step goes: model (forward + backward) against
    optimizer, by CUDA events, and the top device kernels of one step by
    ``torch.profiler`` (table in chiprun_out/step_profile.txt)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.optimizers import linear_warmup_linear_decay, make_optimizer
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sr
    from repro_torch.models import init_model, loss_fn
    from repro_torch.train.train_loop import make_train_state

    cfg = get_config("internlm2-1.8b")
    model = init_model(cfg, seed=0, device=dev)
    opt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 1, 10))
    state = make_train_state(model, opt, key=sr.PRNGKey(0))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 128, 8))

    def step(t):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(t).items()}
        for p in state.params.values():
            p.grad = None
        ev[0].record()
        loss, _ = loss_fn(model, batch)
        loss.backward()
        ev[1].record()
        grads = {k: p.grad for k, p in state.params.items()}
        with torch.no_grad():
            _, state.opt_state = opt.update(grads, state.opt_state, state.params,
                                            key=sr.fold_in(state.key, t))
        ev[2].record()
        ev[2].synchronize()
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    for t in range(2):
        step(t)
    model_ms, opt_ms = step(2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(3)
    avgs = prof.key_averages()
    self_dev = lambda e: (getattr(e, "self_device_time_total", None)
                          or getattr(e, "self_cuda_time_total", 0))
    kernels = sorted((e for e in avgs if self_dev(e) > 0), key=self_dev, reverse=True)
    OUT_DIR.mkdir(exist_ok=True)
    sort_key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
                else "self_cuda_time_total")
    (OUT_DIR / "step_profile.txt").write_text(avgs.table(sort_by=sort_key, row_limit=40))
    print(f"step split (CUDA events, step 3): model fwd+bwd {model_ms:.1f} ms, "
          f"optimizer {opt_ms:.1f} ms")
    for e in kernels[:8]:
        print(f"  device {self_dev(e) / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    del model, state, prof
    torch.cuda.empty_cache()
    return model_ms, opt_ms


def main():
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    try:
        from repro_torch.kernels import adamw4bit
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase_build()
    max_err, leaves, per_step = phase_leaves(dev)
    small = phase_small_reference(dev)
    counts, losses = phase_main_path(adamw4bit.LAUNCHES)
    model_ms, opt_ms = phase_profile(dev)

    kernels = [{
        "name": "fused_adamw4",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fused_adamw4.cu",
        "replaces": "src/repro/kernels/adamw4bit.py:233",
        "launches": counts["fused_adamw4"],
        "max_abs_err": max_err,
        # one training step's four launches (wo, w1, w2, w3), SR
        "ms": per_step["sr_ms"],
        "plain_ms": per_step["plain_ms"],
        "bound_ms": per_step["bound_ms"],
        "bound_by": per_step["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    }]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "leaves": leaves, "per_step": per_step,
         "small_reference": small, "losses": losses,
         "step_split_ms": {"model": model_ms, "optimizer": opt_ms},
         "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

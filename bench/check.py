"""How ``correct`` is decided: the program's first steps held against the
plain reference following the same steps from the same weights and batches.

The numbers, each against its limit where the workload file gives one:

* ``loss_gap``: the largest ``|L - L_ref| / |L_ref|`` over the steps;
* ``grad_gap``: the first gradient as the optimizer got it, worked out from
  each side's state after one step (its first moment as stored, divided by
  ``1 - b1``); per leaf the gap between the two norms over the larger of
  the reference leaf's norm and the median leaf's; the worst leaf;
* ``change_gap``: the same of each leaf's change ``||p - p0||`` after the
  steps, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone);
* ``grad_gap_median``, ``change_gap_median``: the median leaf's gap of each.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import weights
from reference import model as ref_model
from reference import optim as ref_optim
from reference import quant

NAMES = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median", "change_gap_median")
STILL = 1e-3


def _unpacked_m_norm(q) -> float:
    """Norm of a program state's packed 4-bit B128/DE first moment."""
    cfg = q.config
    if (cfg.bits, cfg.normalization, cfg.block_size, cfg.mapping, cfg.signed) != (
            4, "blockwise", 128, "de", True) or q.shape[-1] % 2:
        raise ValueError(f"no reading for a first moment quantized as {cfg}")
    codes = q.codes.reshape(-1)
    t = quant.table("de_signed", codes.device)
    step = 1 << 24  # bytes: 2^25 codes a piece, a multiple of 128
    total = torch.zeros((), dtype=torch.float64, device=codes.device)
    for a in range(0, codes.numel(), step):
        c = codes[a:a + step]
        flat = torch.stack([c & 15, c >> 4], dim=-1).reshape(-1)
        x = t[flat.long()] * quant.block_range(q.scales[0], 2 * a, 2 * a + flat.numel())
        total += torch.sum(x.to(torch.float64) ** 2)
    return float(torch.sqrt(total))


def moments(opt_state) -> Dict[str, Dict[str, object]]:
    """``{path: {"m": leaf, "v": leaf}}`` of every state object carrying
    ``m`` and ``v`` dicts (Adam's), found by walking the state."""
    out: Dict[str, Dict[str, object]] = {}
    seen = set()

    def walk(node):
        if id(node) in seen or isinstance(node, (torch.Tensor, str, int, float, type(None))):
            return
        seen.add(id(node))
        m, v = getattr(node, "m", None), getattr(node, "v", None)
        if isinstance(m, dict) and isinstance(v, dict):
            for k in m:
                out[k] = {"m": m[k], "v": v[k]}
        if isinstance(node, dict):
            children = node.values()
        elif isinstance(node, (tuple, list)):
            children = node
        else:
            children = [getattr(node, s) for s in getattr(node, "__slots__", ())
                        if hasattr(node, s)] + list(getattr(node, "__dict__", {}).values())
        for c in children:
            walk(c)

    walk(opt_state)
    return out


def tensor_bytes(node) -> int:
    """Bytes of every tensor reachable in ``node``, each counted once."""
    seen = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            seen[(x.untyped_storage().data_ptr(), x.storage_offset(), x.numel())] = (
                x.numel() * x.element_size())
        elif isinstance(x, dict):
            for c in x.values():
                walk(c)
        elif isinstance(x, (tuple, list)):
            for c in x:
                walk(c)
        elif not isinstance(x, (str, int, float, type(None))):
            for s in getattr(x, "__slots__", ()):
                if hasattr(x, s):
                    walk(getattr(x, s))
            for c in getattr(x, "__dict__", {}).values():
                walk(c)

    walk(node)
    return sum(seen.values())


def first_norms(opt_state, b1: float) -> Dict[str, float]:
    """Per leaf the first gradient from a program state after one step."""
    out = {}
    for k, mv in moments(opt_state).items():
        m = mv["m"]
        norm = (float(torch.linalg.vector_norm(m)) if isinstance(m, torch.Tensor)
                else _unpacked_m_norm(m))
        out[k] = norm / (1.0 - b1)
    return out


def follow(config: dict, workload: dict, batches: List[dict], seed: int, device, steps: int,
           rounding: Optional[str] = None, part=None) -> dict:
    """The reference's readings over the first ``steps`` steps: ``losses``
    (per step), and per leaf ``first`` (the first gradient's norm from the
    state), ``change`` (``||p - p0||``) and ``grad`` (the first gradient's
    norm). Its products round as the configuration's compute type, or as
    ``rounding`` (the control's); ``part`` indexes the part of every batch
    it keeps (a planted fault)."""
    rounding = rounding or ref_model.COMPUTE[config["run"]["compute_dtype"]]
    shapes = ref_model.leaf_shapes(config)
    std = config["initializer_range"]
    params = weights.make(shapes, seed, std, device)
    for p in params.values():
        p.requires_grad_(True)
    opt = ref_optim.Adam4(shapes, device, lr=workload["lr"], warmup=workload["warmup"],
                          total=workload["total_steps"], seed=seed, b1=workload["b1"])
    out = {"losses": [], "first": {}, "change": {}, "grad": {}}
    for t in range(1, steps + 1):
        batch = batches[t - 1]
        tok, lab = (torch.as_tensor(batch[k], device=device) for k in ("tokens", "labels"))
        if part is not None:
            tok, lab = tok[part], lab[part]
        for p in params.values():
            p.grad = None
        loss = ref_model.loss(params, config, tok, lab, rounding)
        loss.backward()
        out["losses"].append(float(loss.detach()))
        grads = {k: p.grad for k, p in params.items()}
        if t == 1:
            out["grad"] = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
        opt.step({k: p.data for k, p in params.items()}, grads, t)
        del grads, loss
        if t == 1:
            out["first"] = {k: opt.m_dequant_norm(k) / (1.0 - workload["b1"]) for k in params}
    for p in params.values():
        p.grad = None
    out["change"] = {k: weights.change_norm(k, p.data, shapes, seed, std)
                     for k, p in params.items()}
    return out


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    keys = [k for k in ref if keep(k)]
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def _worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    """The largest gap and its leaf; NaN counts as the largest."""
    worst, at = 0.0, ""
    for k, gap in gaps.items():
        if not gap <= worst:
            worst, at = gap, k
            if np.isnan(gap):
                break
    return worst, at


def gaps(prog: dict, ref: dict) -> Dict[str, Dict[str, object]]:
    """Every number of ``NAMES``, each with the step or leaf where it is
    worst: the worst leaf's gaps and, steadier where a few leaves swing
    (routing at near ties), the median leaf's."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    worst_t = int(np.argmax(losses)) if all(np.isfinite(losses)) else 0
    med_g = statistics.median(ref["grad"].values())
    moving = lambda k: ref["grad"][k] >= STILL * med_g
    out = {"loss_gap": {"value": float(max(losses)) if all(np.isfinite(losses))
                        else float("nan"), "at": f"step {worst_t + 1}"}}
    for name, leaf_gaps in (("grad_gap", _leaf_gaps(prog["first"], ref["first"], lambda k: True)),
                            ("change_gap", _leaf_gaps(prog["change"], ref["change"], moving))):
        worst, at = _worst(leaf_gaps)
        out[name] = {"value": worst, "at": at}
        vals = list(leaf_gaps.values())
        out[name + "_median"] = {"value": float("nan") if any(np.isnan(vals))
                                 else float(statistics.median(vals)), "at": "median leaf"}
    return out


def judge(found: Dict[str, Dict[str, object]], limits: Dict[str, float]) -> bool:
    """Whether every number the cell compares (those ``limits`` names) is
    within its limit."""
    return all(bool(found[n]["value"] <= limit) for n, limit in limits.items())

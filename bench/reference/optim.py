"""The production 4-bit AdamW step in plain torch: what the program's
``production4bit`` optimizer is defined to compute, worked out again.

* Leaves whose path names an embedding, head, norm, scale or bias take fp32
  AdamW; every other leaf keeps its moments in 4 bits (B128/DE m,
  Rank-1/Linear v) with stochastic rounding, except a leaf of at most 4096
  elements, whose moments stay fp32.
* A 4-bit leaf of two or more dims whose last dim is a multiple of 256 takes
  the fused update: m and v are updated, the parameter stepped and both
  moments requantized per (R, C) slice, the new v statistics taken over the
  whole leaf first, the noise of slice ``l`` keyed by ``fold_in(leaf key,
  l)`` at the slice's counters (stream 0 for m, 1 for v).
* Any other 4-bit leaf is updated in fp32 from its dequantized moments and
  requantized whole, m and v with the two keys ``split(leaf key, 2)``.
* Keys: the step's ``fold_in(PRNGKey(seed), step - 1)``, folded with the
  partition's index (``4bit`` 0, ``fp32`` 1), then with the leaf's index
  inside its partition, leaves in the tree order of their paths.
* Learning rate: linear warm-up then linear decay, in fp32; decoupled weight
  decay; bias corrections ``1 - b^t`` in fp32.

A quantized moment is a dict ``{"codes", "scales"}`` (unpacked uint8
codes). ``chunk`` bounds the elements of any temporary.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from reference import quant, threefry

FP32_PATTERNS = (r"embed", r"head", r"norm", r"(^|/)scale($|/)", r"(^|/)bias($|/)", r"(^|/)ln_")
LABEL_ORDER = {"4bit": 0, "fp32": 1}
RAW_THRESHOLD = 4096


def path_key(path: str):
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c) for c in path.split("/"))


def tree_order(paths) -> List[str]:
    return sorted(paths, key=path_key)


def label(path: str) -> str:
    return "fp32" if any(re.search(p, path) for p in FP32_PATTERNS) else "4bit"


def fp32_power(base: float, t: int) -> np.float32:
    return np.float32(np.float64(np.float32(base)) ** np.float64(np.float32(t)))


def lr_at(t: int, lr: float, warmup: int, total: int) -> np.float32:
    f = np.float32
    s = f(t)
    warm = f(lr) * s / f(max(1.0, float(warmup)))
    decay = f(lr) * max(f(0.0), (f(total) - s) / f(max(1.0, float(total - warmup))))
    return f(warm if s < warmup else decay)


def route(path: str, shape) -> str:
    """``fp32``, ``raw`` (4-bit partition, fp32 moments), ``fused`` or ``unfused``."""
    if label(path) == "fp32":
        return "fp32"
    if int(np.prod(shape)) <= RAW_THRESHOLD:
        return "raw"
    if len(shape) >= 2 and shape[-1] % 256 == 0:
        return "fused"
    return "unfused"


class Adam4:
    """The optimizer's state and step over ``{path: fp32 tensor}``."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], device, *, lr: float, warmup: int,
                 total: int, seed: int, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                 chunk: int = 1 << 25):
        self.hp = dict(lr=lr, warmup=warmup, total=total, b1=b1, b2=b2, eps=eps, wd=weight_decay)
        self.key = threefry.prng_key(seed)
        self.chunk = chunk
        self.t_m = quant.table("de_signed", device)
        self.t_v = quant.table("linear_unsigned", device)
        self.routes = {k: route(k, s) for k, s in shapes.items()}
        self.state = {}
        zero_m = int(torch.nonzero(self.t_m == 0)[0, 0])
        for k, shape in shapes.items():
            if self.routes[k] in ("fp32", "raw"):
                z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
                self.state[k] = {"m": z(), "v": z()}
            else:  # quantized zeros, rounded to nearest: m exactly 0, v the table's least point
                n = int(np.prod(shape))
                self.state[k] = {
                    "m": {"codes": torch.full(shape, zero_m, dtype=torch.uint8, device=device),
                          "scales": torch.ones(-(-n // quant.BLOCK), device=device)},
                    "v": {"codes": torch.zeros(shape, dtype=torch.uint8, device=device),
                          "stats": tuple(torch.zeros(d, device=device) for d in shape)},
                }

    # -- reading the state -------------------------------------------------

    def m_dequant_norm(self, k: str) -> float:
        """The norm of leaf ``k``'s first moment as stored."""
        m = self.state[k]["m"]
        if isinstance(m, torch.Tensor):
            return float(torch.linalg.vector_norm(m))
        return dequant_block_norm(m["codes"], m["scales"], self.t_m, self.chunk)

    # -- the step ----------------------------------------------------------

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], t: int):
        hp = self.hp
        lr = lr_at(t, hp["lr"], hp["warmup"], hp["total"])
        bc1 = np.float32(1.0) - fp32_power(hp["b1"], t)
        bc2 = np.float32(1.0) - fp32_power(hp["b2"], t)
        step_key = threefry.fold_in(self.key, t - 1)
        for lab in ("4bit", "fp32"):
            k_lab = threefry.fold_in(step_key, LABEL_ORDER[lab])
            leaves = [k for k in tree_order(params) if label(k) == lab]
            for i, k in enumerate(leaves):
                lk = threefry.fold_in(k_lab, i)
                r = self.routes[k]
                args = (params[k], grads[k].to(torch.float32), self.state[k], lr, bc1, bc2)
                if r in ("fp32", "raw"):
                    self._adam_fp32(*args)
                elif r == "fused":
                    self._fused(*args, lk)
                else:
                    self._unfused(*args, lk)

    def _direction(self, m, v, g, bc1, bc2):
        hp = self.hp
        m2 = hp["b1"] * m + (1.0 - hp["b1"]) * g
        v2 = hp["b2"] * v + (1.0 - hp["b2"]) * g * g
        u = (m2 / float(bc1)) / (torch.sqrt(v2 / float(bc2)) + hp["eps"])
        return m2, v2, u

    def _apply(self, p, u, lr):
        p.add_(-float(lr) * (u + self.hp["wd"] * p))

    def _adam_fp32(self, p, g, st, lr, bc1, bc2):
        st["m"], st["v"], u = self._direction(st["m"], st["v"], g, bc1, bc2)
        self._apply(p, u, lr)

    def _unfused(self, p, g, st, lr, bc1, bc2, lk):
        shape, n = p.shape, p.numel()
        m = (quant.decode(st["m"]["codes"], self.t_m).reshape(-1)
             * quant.per_block(st["m"]["scales"], n)).reshape(shape)
        v = quant.decode(st["v"]["codes"], self.t_v) * quant.rank1_scale(st["v"]["stats"], shape)
        m2, v2, u = self._direction(m, v, g, bc1, bc2)
        del m, v
        self._apply(p, u, lr)
        del u
        km, kv = threefry.split(lk, 2)
        st["m"] = self._quant_block(m2, km)
        st["v"] = self._quant_rank1(v2, kv)

    def _quant_block(self, x, key):
        n = x.numel()
        scales = quant.block_scales(x)
        flat = x.reshape(-1)
        codes = torch.empty(n, dtype=torch.uint8, device=x.device)
        for a in range(0, n, self.chunk):
            b = min(n, a + self.chunk)
            u = threefry.jax_uniform(key, a, b - a, x.device)
            codes[a:b] = quant.encode_stochastic(flat[a:b] / quant.block_range(scales, a, b),
                                                 self.t_m, u)
        return {"codes": codes.reshape(x.shape), "scales": scales}

    def _quant_rank1(self, x, key):
        stats = quant.rank1_stats(x)
        n = x.numel()
        flat = (x / quant.rank1_scale(stats, x.shape)).reshape(-1)
        codes = torch.empty(n, dtype=torch.uint8, device=x.device)
        for a in range(0, n, self.chunk):
            b = min(n, a + self.chunk)
            codes[a:b] = quant.encode_stochastic(flat[a:b], self.t_v,
                                                 threefry.jax_uniform(key, a, b - a, x.device))
        return {"codes": codes.reshape(x.shape), "stats": stats}

    def _fused(self, p, g, st, lr, bc1, bc2, lk):
        shape = tuple(p.shape)
        R, C = shape[-2], shape[-1]
        lead = shape[:-2]
        L = int(np.prod(lead)) if lead else 1
        hp = self.hp
        w3, g3 = p.reshape(L, R, C), g.reshape(L, R, C)
        mc3 = st["m"]["codes"].reshape(L, R, C)
        ms3 = st["m"]["scales"].reshape(L, R, C // quant.BLOCK)
        vc3 = st["v"]["codes"].reshape(L, R, C)
        stats = st["v"]["stats"]
        lead_min = _lead_min(stats[:-2], lead, p.device)  # (L,)
        row, col = stats[-2], stats[-1]
        rows = max(1, self.chunk // C)

        def v_old(l, a, b):
            s = torch.minimum(torch.minimum(lead_min[l], row[a:b])[:, None], col[None, :])
            return quant.decode(vc3[l, a:b], self.t_v) * quant.guard(s)

        # pass 1: the per-dim maxima of the updated v over the whole leaf
        row_max = torch.zeros(L, R, device=p.device)
        col_max = torch.zeros(C, device=p.device)
        for l in range(L):
            for a in range(0, R, rows):
                b = min(R, a + rows)
                gg = g3[l, a:b]
                vn = hp["b2"] * v_old(l, a, b) + (1.0 - hp["b2"]) * gg * gg
                row_max[l, a:b] = torch.amax(vn, dim=1)
                col_max = torch.maximum(col_max, torch.amax(vn, dim=0))
        rows_full = row_max.reshape(*lead, R) if lead else row_max[0]
        new_stats = tuple(
            torch.amax(rows_full, dim=tuple(i for i in range(rows_full.ndim) if i != r))
            if rows_full.ndim > 1 else rows_full for r in range(rows_full.ndim)) + (col_max,)
        new_lead = _lead_min(new_stats[:-2], lead, p.device)
        new_row = new_stats[-2]
        m_codes = torch.empty_like(mc3)
        m_scales = torch.empty_like(ms3)
        v_codes = torch.empty_like(vc3)
        # pass 2: the update and the requantization, slice by slice
        for l in range(L):
            seed = threefry.fold_in(lk, l)
            for a in range(0, R, rows):
                b = min(R, a + rows)
                gg = g3[l, a:b]
                m = (quant.decode(mc3[l, a:b], self.t_m)
                     * torch.repeat_interleave(ms3[l, a:b], quant.BLOCK, dim=-1))
                m2, v2, u = self._direction(m, v_old(l, a, b), gg, bc1, bc2)
                self._apply(w3[l, a:b], u, lr)
                blocks = m2.reshape(b - a, C // quant.BLOCK, quant.BLOCK)
                sc = quant.guard(torch.amax(torch.abs(blocks), dim=-1))
                m_scales[l, a:b] = sc
                n_m = (blocks / sc[..., None]).reshape(b - a, C)
                m_codes[l, a:b] = quant.encode_stochastic(
                    n_m, self.t_m,
                    threefry.slice_uniform(seed, a, b - a, C, threefry.STREAM_M, p.device))
                s_new = torch.minimum(torch.minimum(new_lead[l], new_row[a:b])[:, None],
                                      new_stats[-1][None, :])
                v_codes[l, a:b] = quant.encode_stochastic(
                    v2 / quant.guard(s_new), self.t_v,
                    threefry.slice_uniform(seed, a, b - a, C, threefry.STREAM_V, p.device))
        st["m"] = {"codes": m_codes.reshape(shape), "scales": m_scales.reshape(-1)}
        st["v"] = {"codes": v_codes.reshape(shape), "stats": new_stats}


def _lead_min(stats, lead, device) -> torch.Tensor:
    """(L,) least of the leading dims' statistics per slice (inf with none)."""
    out = torch.full(lead if lead else (1,), float("inf"), device=device)
    for r, st in enumerate(stats):
        view = [1] * len(lead)
        view[r] = lead[r]
        out = torch.minimum(out, st.reshape(view))
    return out.reshape(-1)


def dequant_block_norm(codes, scales, table, chunk: int) -> float:
    """Norm of a B128 tensor from its codes (any integer dtype, one code an
    element) and block scales, in flat pieces of at most ``chunk``."""
    flat = codes.reshape(-1)
    n = flat.numel()
    step = max(quant.BLOCK, chunk // quant.BLOCK * quant.BLOCK)
    total = torch.zeros((), dtype=torch.float64, device=codes.device)
    for a in range(0, n, step):
        b = min(n, a + step)
        x = table[flat[a:b].long()] * quant.block_range(scales, a, b)
        total += torch.sum(x.to(torch.float64) ** 2)
    return float(torch.sqrt(total))

"""The dense transformer block: attention + (gated) MLP, pre-norm.

Port of ``repro/models/blocks.py`` (``LayerSpec``, ``apply_attention`` for
training, ``apply_mlp`` and the dense block). A ``DenseStack`` holds the
parameters of ``L`` identical layers stacked on a leading dim, in the
reference's layout and under its names (``attn/wq`` ``(L, D, H, dh)``,
``mlp/w1`` ``(L, D, F)``, ``norm1`` ``(L, D)``, ...), so the optimizer sees
the reference's leaves.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import COMPUTE_DTYPE, dense, rmsnorm, rope

__all__ = ["LayerSpec", "DenseStack", "apply_attention", "apply_mlp", "apply_dense"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "dense"
    window: int = 0  # 0 = full attention; >0 = sliding window


def _stacked(L, shape, device):
    return nn.Parameter(torch.empty((L,) + tuple(shape), dtype=torch.float32, device=device))


class DenseStack(nn.Module):
    """Parameters of ``L`` dense layers, stacked (one scan unit)."""

    def __init__(self, cfg, L: int, device):
        super().__init__()
        D, Hq, Hkv, dh, Ff = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
        self.attn = nn.ParameterDict({
            "wq": _stacked(L, (D, Hq, dh), device),
            "wk": _stacked(L, (D, Hkv, dh), device),
            "wv": _stacked(L, (D, Hkv, dh), device),
            "wo": _stacked(L, (Hq, dh, D), device),
        })
        mlp = {"w1": _stacked(L, (D, Ff), device), "w2": _stacked(L, (Ff, D), device)}
        if cfg.gated_mlp:
            mlp["w3"] = _stacked(L, (D, Ff), device)
        self.mlp = nn.ParameterDict(mlp)
        self.norm1 = _stacked(L, (D,), device)
        self.norm2 = _stacked(L, (D,), device)
        self.L = L

    def layers(self):
        """Per-layer parameter dicts, as views of the stacked tensors
        (one unbind per tensor, so backward stacks the grads once)."""
        attn = {k: p.unbind(0) for k, p in self.attn.items()}
        mlp = {k: p.unbind(0) for k, p in self.mlp.items()}
        n1, n2 = self.norm1.unbind(0), self.norm2.unbind(0)
        for l in range(self.L):
            yield {
                "attn": {k: v[l] for k, v in attn.items()},
                "mlp": {k: v[l] for k, v in mlp.items()},
                "norm1": n1[l],
                "norm2": n2[l],
            }


def apply_attention(p, x: torch.Tensor, cfg, *, window: int = 0, positions=None) -> torch.Tensor:
    """Self-attention for training (no cache)."""
    q = dense(x, p["wq"], "bsd,dhe->bshe")
    k = dense(x, p["wk"], "bsd,dhe->bshe")
    v = dense(x, p["wv"], "bsd,dhe->bshe")
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = attn_lib.train_attention(q, k, v, causal=True, window=window)
    return torch.einsum("bshe,hed->bsd", out.to(COMPUTE_DTYPE), p["wo"].to(COMPUTE_DTYPE))


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = dense(x, p["w1"], "bsd,df->bsf")
    a = F.silu(h)
    if "w3" in p:
        a = a * dense(x, p["w3"], "bsd,df->bsf")
    return torch.einsum("bsf,fd->bsd", a, p["w2"].to(COMPUTE_DTYPE))


def apply_dense(p, x: torch.Tensor, spec: LayerSpec, cfg, *, positions) -> torch.Tensor:
    h = apply_attention(p["attn"], rmsnorm(x, p["norm1"]), cfg, window=spec.window,
                        positions=positions)
    x = x + h
    return x + apply_mlp(p["mlp"], rmsnorm(x, p["norm2"]))

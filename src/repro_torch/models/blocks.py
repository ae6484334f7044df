"""The dense transformer block: attention + (gated) MLP, pre-norm.

Port of ``repro/models/blocks.py`` (``LayerSpec``, ``apply_attention`` with
its three cache regimes, ``apply_mlp``, the dense block and its decode
cache). A ``DenseStack`` holds the parameters of ``L`` identical layers
stacked on a leading dim, in the reference's layout and under its names
(``attn/wq`` ``(L, D, H, dh)``, ``mlp/w1`` ``(L, D, F)``, ``norm1``
``(L, D)``, ...), so the optimizer sees the reference's leaves; training and
serving both walk the layers through ``unstack``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import COMPUTE_DTYPE, dense, rmsnorm, rope

__all__ = ["LayerSpec", "DenseStack", "unstack", "apply_attention", "apply_mlp", "apply_dense",
           "init_block_cache"]


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
        """Per-layer parameter dicts (views of the stacked tensors)."""
        return unstack({"attn": dict(self.attn), "mlp": dict(self.mlp),
                        "norm1": self.norm1, "norm2": self.norm2}, self.L)


def unstack(tree: Dict[str, Any], L: int) -> Iterator[Dict[str, Any]]:
    """Nested dict of stacked ``(L, ...)`` tensors -> one dict per layer, as
    views (one unbind per tensor, so backward stacks the grads once)."""

    def split(node):
        if isinstance(node, dict):
            return {k: split(v) for k, v in node.items()}
        return node.unbind(0)

    def pick(node, l):
        if isinstance(node, dict):
            return {k: pick(v, l) for k, v in node.items()}
        return node[l]

    parts = split(tree)
    for l in range(L):
        yield pick(parts, l)


def apply_attention(p, x: torch.Tensor, cfg, *, window: int = 0, positions=None,
                    cache: Optional[attn_lib.KVCache] = None,
                    cur_pos: Optional[torch.Tensor] = None,
                    kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention.

    Three cache regimes, as the reference's: ``cache`` + ``cur_pos`` with a
    one-token input is a decode step (circular write, position-masked
    attention); ``cache`` + ``kv_lengths`` with a whole sequence is a one-shot
    prefill (training attention, then the whole K/V sequence written into
    the cache at once); without a cache it is training attention. The cache
    is written in place.
    """
    q = dense(x, p["wq"], "bsd,dhe->bshe")
    k = dense(x, p["wk"], "bsd,dhe->bshe")
    v = dense(x, p["wv"], "bsd,dhe->bshe")
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cache is not None and cur_pos is not None and x.shape[1] == 1:
        attn_lib.cache_update(cache, k, v, cur_pos)
        out = attn_lib.decode_attention(q, cache, cur_pos, window=window,
                                        k_chunk=cfg.decode_k_chunk)
    else:
        out = attn_lib.train_attention(q, k, v, causal=True, window=window)
        if cache is not None and kv_lengths is not None:
            attn_lib.cache_prefill(cache, k, v, kv_lengths)
    return torch.einsum("bshe,hed->bsd", out.to(COMPUTE_DTYPE), p["wo"].to(COMPUTE_DTYPE))


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = dense(x, p["w1"], "bsd,df->bsf")
    a = F.silu(h)
    if "w3" in p:
        a = a * dense(x, p["w3"], "bsd,df->bsf")
    return torch.einsum("bsf,fd->bsd", a, p["w2"].to(COMPUTE_DTYPE))


def apply_dense(p, x: torch.Tensor, spec: LayerSpec, cfg, *, positions,
                cache: Optional[attn_lib.KVCache] = None,
                cur_pos: Optional[torch.Tensor] = None,
                kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-norm dense block (the cache regimes of ``apply_attention``)."""
    h = apply_attention(p["attn"], rmsnorm(x, p["norm1"]), cfg, window=spec.window,
                        positions=positions, cache=cache, cur_pos=cur_pos, kv_lengths=kv_lengths)
    x = x + h
    return x + apply_mlp(p["mlp"], rmsnorm(x, p["norm2"]))


def init_block_cache(cfg, spec: LayerSpec, batch: int, s_max: int, *, device,
                     layers: int) -> attn_lib.KVCache:
    """Decode-time cache of a dense block, stacked over ``layers``.
    Windowed layers allocate only ``window`` slots; the slot count is at
    least 256 and a multiple of 256, as in the reference."""
    if spec.kind != "dense":
        raise ValueError(f"the port caches dense blocks only, not {spec.kind!r}")
    slots = min(s_max, spec.window) if spec.window > 0 else s_max
    slots = max(256, slots)
    if slots % 256:
        slots += 256 - slots % 256
    return attn_lib.make_cache(batch, slots, cfg.num_kv_heads, cfg.head_dim,
                               device=device, layers=layers)

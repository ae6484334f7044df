"""The dense and MoE transformer blocks: attention + (gated) MLP or a
mixture of experts, pre-norm, with the reference's options (q/k RMS norm,
2-D RoPE, attention softcap, sandwich norms, gelu).

Port of ``repro/models/blocks.py`` (``LayerSpec``, ``apply_attention`` with
its three cache regimes, ``apply_mlp``, the dense and MoE blocks and their
decode cache). A ``DenseStack`` or ``MoEStack`` holds the parameters of
``L`` identical layers stacked on a leading dim, in the reference's layout
and under its names (``attn/wq`` ``(L, D, H, dh)``, ``attn/q_norm`` ``(L,
dh)``, ``mlp/w1`` ``(L, D, F)``, ``moe/router`` ``(L, D, E)``, ``moe/w1``
``(L, E, D, F)``, ``norm1``, ``post1`` ``(L, D)``, ...), so the optimizer
sees the reference's leaves; training and serving both walk the layers
through ``unstack``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import COMPUTE_DTYPE, dense, rmsnorm, rope, rope_half
from repro_torch.models.moe import moe_apply

__all__ = ["LayerSpec", "DenseStack", "MoEStack", "STACKS", "unstack", "apply_attention",
           "apply_mlp", "apply_dense", "apply_moe", "init_block_cache"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "dense"
    window: int = 0  # 0 = full attention; >0 = sliding window


def _stacked(L, shape, device):
    return nn.Parameter(torch.empty((L,) + tuple(shape), dtype=torch.float32, device=device))


def _attention_params(cfg, L: int, device) -> nn.ParameterDict:
    D, Hq, Hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = {
        "wq": _stacked(L, (D, Hq, dh), device),
        "wk": _stacked(L, (D, Hkv, dh), device),
        "wv": _stacked(L, (D, Hkv, dh), device),
        "wo": _stacked(L, (Hq, dh, D), device),
    }
    if cfg.qk_norm:
        attn["q_norm"] = _stacked(L, (dh,), device)
        attn["k_norm"] = _stacked(L, (dh,), device)
    return nn.ParameterDict(attn)


class _Stack(nn.Module):
    def layers(self):
        """Per-layer parameter dicts (views of the stacked tensors)."""
        tree = {name: dict(m) for name, m in self.named_children()}
        tree.update((k, p) for k, p in self.named_parameters(recurse=False))
        return unstack(tree, self.L)


class DenseStack(_Stack):
    """Parameters of ``L`` dense layers, stacked (one scan unit)."""

    def __init__(self, cfg, L: int, device):
        super().__init__()
        D, Ff = cfg.d_model, cfg.d_ff
        self.attn = _attention_params(cfg, L, device)
        mlp = {"w1": _stacked(L, (D, Ff), device), "w2": _stacked(L, (Ff, D), device)}
        if cfg.gated_mlp:
            mlp["w3"] = _stacked(L, (D, Ff), device)
        self.mlp = nn.ParameterDict(mlp)
        self.norm1 = _stacked(L, (D,), device)
        self.norm2 = _stacked(L, (D,), device)
        if cfg.sandwich_norm:
            self.post1 = _stacked(L, (D,), device)
            self.post2 = _stacked(L, (D,), device)
        self.L = L


class MoEStack(_Stack):
    """Parameters of ``L`` MoE layers, stacked (one scan unit): attention,
    ``moe/router (L, D, E)``, ``moe/w1``, ``moe/w3 (L, E, D, F)``, ``moe/w2
    (L, E, F, D)``, ``norm1``, ``norm2``."""

    def __init__(self, cfg, L: int, device):
        super().__init__()
        D, Ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.attn = _attention_params(cfg, L, device)
        self.moe = nn.ParameterDict({
            "router": _stacked(L, (D, E), device),
            "w1": _stacked(L, (E, D, Ff), device),
            "w3": _stacked(L, (E, D, Ff), device),
            "w2": _stacked(L, (E, Ff, D), device),
        })
        self.norm1 = _stacked(L, (D,), device)
        self.norm2 = _stacked(L, (D,), device)
        self.L = L


# the parameter stack of each block kind the port runs
STACKS = {"dense": DenseStack, "moe": MoEStack}


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


def _qk_normalize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm of q or k over head_dim (fp32, eps 1e-6)."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _rope_apply(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope_variant == "rope2d":
        return rope_half(x, positions, cfg.rope_theta)
    return rope(x, positions, cfg.rope_theta)


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
    if "q_norm" in p:
        q = _qk_normalize(q, p["q_norm"])
    k = dense(x, p["wk"], "bsd,dhe->bshe")
    v = dense(x, p["wv"], "bsd,dhe->bshe")
    if "k_norm" in p:
        k = _qk_normalize(k, p["k_norm"])
    if positions is not None:
        q = _rope_apply(cfg, q, positions)
        k = _rope_apply(cfg, k, positions)
    if cache is not None and cur_pos is not None and x.shape[1] == 1:
        attn_lib.cache_update(cache, k, v, cur_pos)
        out = attn_lib.decode_attention(q, cache, cur_pos, window=window,
                                        softcap_val=cfg.attn_softcap,
                                        k_chunk=cfg.decode_k_chunk)
    else:
        out = attn_lib.train_attention(q, k, v, causal=True, window=window,
                                       softcap_val=cfg.attn_softcap)
        if cache is not None and kv_lengths is not None:
            attn_lib.cache_prefill(cache, k, v, kv_lengths)
    return torch.einsum("bshe,hed->bsd", out.to(COMPUTE_DTYPE), p["wo"].to(COMPUTE_DTYPE))


def apply_mlp(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """(Gated) MLP. ``gelu`` is the tanh form: ``jax.nn.gelu``'s default."""
    h = dense(x, p["w1"], "bsd,df->bsf")
    a = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
    if "w3" in p:
        a = a * dense(x, p["w3"], "bsd,df->bsf")
    return torch.einsum("bsf,fd->bsd", a, p["w2"].to(COMPUTE_DTYPE))


def apply_dense(p, x: torch.Tensor, spec: LayerSpec, cfg, *, positions,
                cache: Optional[attn_lib.KVCache] = None,
                cur_pos: Optional[torch.Tensor] = None,
                kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-norm dense block (the cache regimes of ``apply_attention``); with
    ``sandwich_norm`` each branch's output is normed again (``post1``,
    ``post2``) before the residual add."""
    h = apply_attention(p["attn"], rmsnorm(x, p["norm1"]), cfg, window=spec.window,
                        positions=positions, cache=cache, cur_pos=cur_pos, kv_lengths=kv_lengths)
    if cfg.sandwich_norm:
        h = rmsnorm(h, p["post1"])
    x = x + h
    h2 = apply_mlp(p["mlp"], rmsnorm(x, p["norm2"]), cfg.act)
    if cfg.sandwich_norm:
        h2 = rmsnorm(h2, p["post2"])
    return x + h2


def apply_moe(p, x: torch.Tensor, spec: LayerSpec, cfg, *, positions,
              cache: Optional[attn_lib.KVCache] = None,
              cur_pos: Optional[torch.Tensor] = None,
              kv_lengths: Optional[torch.Tensor] = None):
    """Pre-norm MoE block (the reference's ``_apply_moe``): attention (the
    cache regimes of ``apply_attention``), then ``x + moe(norm2(x))``.
    Returns (x, the layer's fp32 load-balance aux loss)."""
    h = apply_attention(p["attn"], rmsnorm(x, p["norm1"]), cfg, window=spec.window,
                        positions=positions, cache=cache, cur_pos=cur_pos, kv_lengths=kv_lengths)
    x = x + h
    out, aux = moe_apply(p["moe"], rmsnorm(x, p["norm2"]), top_k=cfg.top_k,
                         group_size=cfg.moe_group_size)
    return x + out, aux


def init_block_cache(cfg, spec: LayerSpec, batch: int, s_max: int, *, device,
                     layers: int) -> attn_lib.KVCache:
    """Decode-time cache of a dense or MoE block (the same K/V cache),
    stacked over ``layers``. Windowed layers allocate only ``window`` slots;
    the slot count is at least 256 and a multiple of 256, as in the
    reference."""
    if spec.kind not in STACKS:
        raise ValueError(f"the port caches dense and moe blocks only, not {spec.kind!r}")
    slots = min(s_max, spec.window) if spec.window > 0 else s_max
    slots = max(256, slots)
    if slots % 256:
        slots += 256 - slots % 256
    return attn_lib.make_cache(batch, slots, cfg.num_kv_heads, cfg.head_dim,
                               device=device, layers=layers)

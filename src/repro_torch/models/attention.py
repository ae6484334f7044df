"""Attention with GQA: training attention, and the serving KV cache with
one-query decode attention (port of ``repro/models/attention.py``).

``train_attention``: the reference runs an online-softmax scan over
(q-chunk, k-chunk) pairs in fp32 (k-chunks of ``attn_k_chunk`` = 1024, so
whisper's 1500 encoder frames take two); the port computes the one masked
softmax over all keys, ``exp(s - max) @ v / sum``, fp32 inside, output in
the input dtype. The two differ by fp32 rounding only (the online softmax
rescales its partial sums per chunk). Self-attention is causal; cross- and
encoder attention (``causal=False``) may have ``Sq != Sk``. q heads are
grouped per kv head, as in the reference (head ``h`` reads kv head
``h // G``).

Serving: ``KVCache`` is the reference's circular cache; ``cache_prefill``
writes a whole right-padded prompt batch at once (a gather), and
``cache_update`` writes one decode step. Unlike the functional reference,
both write into the cache's tensors in place (the serving stack keeps one
``(L, ...)`` cache per layer stack and hands each layer its views) and return
the same cache. ``decode_attention`` is the reference's chunked online
softmax in fp32, masked by each slot's stored position.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["train_attention", "decode_attention", "KVCache", "make_cache",
           "cache_prefill", "cache_update"]

NEG_INF = -1e30


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap_val: float = 0.0) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) -> (B, Sq, Hq, D). A positive
    ``softcap_val`` caps the scaled scores (``cap * tanh(s / cap)``) before
    the mask, as the reference does."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.to(torch.float32).reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.to(torch.float32)) * (1.0 / math.sqrt(D))
    if softcap_val > 0:
        s = softcap_val * torch.tanh(s / softcap_val)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.to(torch.float32))
    out = out / torch.clamp_min(torch.sum(p, dim=-1), 1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


class KVCache(NamedTuple):
    """Circular KV cache. ``pos`` holds the absolute position stored in each
    slot (-1 = empty). A stacked cache carries a leading layer dim."""

    k: torch.Tensor    # (B, Smax, Hkv, D)
    v: torch.Tensor    # (B, Smax, Hkv, D)
    pos: torch.Tensor  # (B, Smax) int32, absolute positions, -1 empty


def make_cache(batch: int, s_max: int, n_kv: int, head_dim: int, *, device,
               layers: int = 0) -> KVCache:
    """An empty bf16 cache; ``layers`` > 0 stacks that many on a leading dim."""
    lead = (layers,) if layers else ()
    shape = lead + (batch, s_max, n_kv, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
        v=torch.zeros(shape, dtype=torch.bfloat16, device=device),
        pos=torch.full(lead + (batch, s_max), -1, dtype=torch.int32, device=device),
    )


def decode_attention(q: torch.Tensor, cache: KVCache, cur_pos: torch.Tensor, *,
                     window: int = 0, softcap_val: float = 0.0,
                     k_chunk: int = 1024) -> torch.Tensor:
    """One query step (B, 1, Hq, D) against the cache; ``cur_pos`` (B,) is
    the query's absolute position. Online softmax over chunks of ``k_chunk``
    slots; slots that are empty, in the future or behind the window are
    masked. ``softcap_val`` caps the scores as in ``train_attention``."""
    B, _, Hq, D = q.shape
    Smax, Hkv = cache.k.shape[1], cache.k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    kc = min(k_chunk, Smax)
    assert Smax % kc == 0, (Smax, kc)
    qg = q.to(torch.float32).reshape(B, Hkv, G, D)
    cur = cur_pos.to(torch.int32)[:, None]
    m = torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    for j0 in range(0, Smax, kc):
        ks = cache.k[:, j0:j0 + kc].to(torch.float32)
        vs = cache.v[:, j0:j0 + kc].to(torch.float32)
        ps = cache.pos[:, j0:j0 + kc]
        s = torch.einsum("bhgd,bkhd->bhgk", qg, ks) * scale
        if softcap_val > 0:
            s = softcap_val * torch.tanh(s / softcap_val)
        ok = (ps >= 0) & (ps <= cur)
        if window > 0:
            ok &= ps > cur - window
        s = torch.where(ok[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vs)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def cache_prefill(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                  lengths: torch.Tensor) -> KVCache:
    """Write a whole right-padded prompt batch (positions 0..S-1) into the
    circular cache, in place. Slot ``s`` of row ``b`` receives the largest
    position ``p < lengths[b]`` with ``p % Smax == s`` (what writing token
    by token would leave), found directly as
    ``p* = s + floor((len - 1 - s) / Smax) * Smax``; a negative ``p*``
    leaves the slot as it was."""
    B, S = k_new.shape[:2]
    Smax = cache.k.shape[1]
    s = torch.arange(Smax, dtype=torch.int64, device=k_new.device)[None, :]
    len_b = lengths.to(torch.int64)[:, None]
    p_star = s + torch.div(len_b - 1 - s, Smax, rounding_mode="floor") * Smax  # (B, Smax)
    valid = p_star >= 0
    pidx = torch.clamp(p_star, 0, S - 1)
    b_idx = torch.arange(B, device=k_new.device)[:, None]
    k_sel = k_new[b_idx, pidx].to(cache.k.dtype)
    v_sel = v_new[b_idx, pidx].to(cache.v.dtype)
    cache.k.copy_(torch.where(valid[..., None, None], k_sel, cache.k))
    cache.v.copy_(torch.where(valid[..., None, None], v_sel, cache.v))
    cache.pos.copy_(torch.where(valid, p_star.to(torch.int32), cache.pos))
    return cache


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor) -> KVCache:
    """Write one decode step (B, 1, Hkv, D) at slot ``pos % Smax``, in place."""
    Smax = cache.k.shape[1]
    slot = torch.remainder(pos.to(torch.int64), Smax)
    b_idx = torch.arange(cache.k.shape[0], device=cache.k.device)
    cache.k[b_idx, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[b_idx, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.pos[b_idx, slot] = pos.to(torch.int32)
    return cache

"""Attention with GQA: training attention, and the serving KV cache with
one-query decode attention (port of ``repro/models/attention.py``).

``train_attention`` is the reference's blockwise online softmax: q and k/v
are padded to multiples of the chunks (``attn_q_chunk`` = 512 queries,
``attn_k_chunk`` = 1024 keys, each at most the sequence), and only the
(q-chunk, k-chunk) pairs that ``_block_pairs`` keeps are computed: a pair
wholly in the future (causal) or wholly behind the window is never formed
(at S = 4096, causal, 20 of the 32 pairs). Each q chunk carries its own
running max, sum and fp32 accumulator over its pairs in ascending k chunk;
a pair scales its scores, caps them (``softcap_val``), masks them with
``NEG_INF`` (causal, window, keys past ``Sk``) and folds them in; a q chunk
with no pair is zeros; the output is ``acc / max(l, 1e-30)``, cropped and
cast to the input dtype. Each pair is recomputed in the backward
(``remat.recomputed``, the reference's ``jax.checkpoint`` of its scan
body), so only the carry is saved, never a pair's probabilities.
Self-attention is causal; cross- and encoder attention (``causal=False``)
may have ``Sq != Sk`` (whisper's 1500 frames pad to 1536 x 2048: 3 x 2
pairs). q heads are grouped per kv head, as in the reference (head ``h``
reads kv head ``h // G``).

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
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.remat import recomputed

__all__ = ["train_attention", "decode_attention", "KVCache", "make_cache",
           "cache_prefill", "cache_update"]

NEG_INF = -1e30


def _block_pairs(nq: int, nk: int, qc: int, kc: int, causal: bool,
                 window: int) -> List[Tuple[int, int]]:
    """The (iq, jk) chunk pairs that can hold an unmasked entry, in the
    reference's order (positions 0..S-1: the training layout)."""
    pairs = []
    for iq in range(nq):
        q_lo, q_hi = iq * qc, (iq + 1) * qc - 1
        for jk in range(nk):
            k_lo, k_hi = jk * kc, (jk + 1) * kc - 1
            if causal and k_lo > q_hi:
                continue  # entirely in the future
            if window > 0 and k_hi < q_lo - window + 1:
                continue  # entirely behind the window
            pairs.append((iq, jk))
    return pairs


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, H, D) padded with ``n`` zero rows on S."""
    return F.pad(x, (0, 0, 0, 0, 0, n)) if n else x


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap_val: float = 0.0,
                    q_chunk: int = 512, k_chunk: int = 1024) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) -> (B, Sq, Hq, D), over the
    (``q_chunk``, ``k_chunk``) block pairs left after pruning. A positive
    ``softcap_val`` caps the scaled scores (``cap * tanh(s / cap)``) before
    the mask, as the reference does."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qc, kc = min(q_chunk, Sq), min(k_chunk, Sk)
    qp, kp, vp = _pad_seq(q, (-Sq) % qc), _pad_seq(k, (-Sk) % kc), _pad_seq(v, (-Sk) % kc)
    nq, nk = qp.shape[1] // qc, kp.shape[1] // kc
    qg = qp.reshape(B, nq * qc, Hkv, G, D)
    pairs = _block_pairs(nq, nk, qc, kc, causal, window)
    dev = q.device

    def step(iq: int, jk: int):
        """The online-softmax step of pair (iq, jk) on a chunk-local carry."""
        q_lo, q_hi, k_lo, k_hi = iq * qc, (iq + 1) * qc - 1, jk * kc, (jk + 1) * kc - 1
        # a pair with no masked entry skips the mask (where(True, s, .) is s)
        whole = (k_hi < Sk and (not causal or k_hi <= q_lo)
                 and (window <= 0 or k_lo > q_hi - window))

        def body(m, l, acc, qs, ks, vs):
            s = torch.einsum("bqhgd,bkhd->bqhgk", qs.to(torch.float32),
                             ks.to(torch.float32)) * scale
            if softcap_val > 0:
                s = softcap_val * torch.tanh(s / softcap_val)
            if not whole:
                q_pos = q_lo + torch.arange(qc, device=dev)
                k_pos = k_lo + torch.arange(kc, device=dev)
                ok = (k_pos < Sk)[None, :].expand(qc, kc)  # padding mask
                if causal:
                    ok = ok & (k_pos[None, :] <= q_pos[:, None])
                if window > 0:
                    ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
                s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l_new = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bqhgk,bkhd->bqhgd", p, vs.to(torch.float32))
            return m_new, l_new, acc * corr[..., None] + pv

        return body

    outs = []
    for iq in range(nq):
        jks = [jk for i, jk in pairs if i == iq]
        if not jks:
            outs.append(torch.zeros((B, qc, Hkv, G, D), dtype=torch.float32, device=dev))
            continue
        qs = qg[:, iq * qc:(iq + 1) * qc]
        m = torch.full((B, qc, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, qc, Hkv, G), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, qc, Hkv, G, D), dtype=torch.float32, device=dev)
        for jk in jks:
            ks, vs = kp[:, jk * kc:(jk + 1) * kc], vp[:, jk * kc:(jk + 1) * kc]
            m, l, acc = recomputed(step(iq, jk), m, l, acc, qs, ks, vs)
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.cat(outs, dim=1).reshape(B, nq * qc, Hq, D)[:, :Sq]
    return out.to(q.dtype)


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

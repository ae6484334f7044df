"""Training attention with GQA and a causal mask (port of
``repro/models/attention.py::train_attention``).

The reference runs an online-softmax scan over (q-chunk, k-chunk) pairs in
fp32; at the slice's sequence lengths (one chunk) that is exactly the
plain masked softmax written here: ``exp(s - max) @ v / sum``, fp32 inside,
output in the input dtype. q heads are grouped per kv head, as in the
reference (head ``h`` reads kv head ``h // G``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["train_attention"]

NEG_INF = -1e30


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.to(torch.float32).reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.to(torch.float32)) * (1.0 / math.sqrt(D))
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

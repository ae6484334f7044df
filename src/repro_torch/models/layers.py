"""Shared layers: rmsnorm, layernorm, embedding lookup, RoPE (full,
half-dim and Qwen2-VL's M-RoPE), whisper's sinusoidal positions, softcap,
chunked cross entropy, and the mesh step's tensor-parallel lookups and
cross entropies (``sharding.tensor_parallel``): vocab-parallel where the
model axis cuts the vocabulary, else column-parallel lookup and
row-parallel cross entropy on the model's width.

Port of ``repro/models/layers.py``. Compute is bf16 with fp32 master
weights cast in (``COMPUTE_DTYPE``, as ``layers.py:34``); norms, RoPE, the
sinusoids and the loss run in fp32 inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.remat import recomputed
from repro_torch.sharding import tensor_parallel as tp_lib

__all__ = [
    "INIT_STD",
    "COMPUTE_DTYPE",
    "dense",
    "rmsnorm",
    "layernorm",
    "embed_lookup",
    "rope",
    "rope_half",
    "mrope",
    "sinusoidal_positions",
    "sinusoidal_at",
    "softcap",
    "chunked_cross_entropy",
    "vocab_parallel_lookup",
    "vocab_parallel_cross_entropy",
    "column_parallel_lookup",
    "row_parallel_cross_entropy",
]

INIT_STD = 0.02
COMPUTE_DTYPE = torch.bfloat16


def dense(x: torch.Tensor, w: torch.Tensor, spec: str) -> torch.Tensor:
    """einsum with bf16 compute, weights cast in."""
    return torch.einsum(spec, x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(COMPUTE_DTYPE)


def layernorm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with ``p = {"scale", "bias"}``; the
    variance is the mean of ``(x - mu)^2``, as ``jnp.var`` computes it."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    xc = x32 - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(COMPUTE_DTYPE)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids.long(), table.to(COMPUTE_DTYPE))


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated by the angles ``ang`` (B, S, D/2), halves
    paired (LLaMA convention), in fp32; back to x's dtype."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x32 = x.to(torch.float32)
    half = x.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Standard RoPE, halves rotated (LLaMA convention). x: (B, S, H, D);
    positions: (B, S)."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def rope_half(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """ChatGLM-style 2-D RoPE: the rotary of the first ``D // 2`` lanes (its
    frequencies from that half width); the second half passes through."""
    half = x.shape[-1] // 2
    return torch.cat([rope(x[..., :half], positions, theta), x[..., half:]], dim=-1)


def mrope(x: torch.Tensor, positions: torch.Tensor, sections, theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the head's D/2 frequency bands split into (t, h, w)
    sections, each rotated by its own position stream. x: (B, S, H, D);
    positions: (3, B, S) (equal streams for pure text); sum(sections) ==
    D // 2."""
    D = x.shape[-1]
    assert sum(sections) == D // 2, (sections, D)
    freqs = _rope_freqs(D, theta, x.device)
    parts, start = [], 0
    for s, sec in enumerate(sections):
        parts.append(positions[s][..., None].to(torch.float32) * freqs[start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings (S, D) in fp32."""
    return sinusoidal_at(torch.arange(length, dtype=torch.float32, device=device), dim)


def sinusoidal_at(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal rows for arbitrary positions (...,) -> (..., D) in fp32:
    ``[sin(p / 10000^(2i/D)), cos(...)]``. The divisor is ``torch.pow``'s;
    the reference's ``jnp.power`` is not correctly rounded, so the two agree
    within fp32 rounding, not bit for bit."""
    idx = torch.arange(dim // 2, dtype=torch.float32, device=pos.device)
    ang = pos.to(torch.float32)[..., None] / torch.pow(10000.0, 2 * idx / dim)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: ``cap * tanh(x / cap)`` in fp32, back to
    the input dtype."""
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, *,
                          logit_cap: float = 0.0, chunk: int = 512, logits_of=None
                          ) -> torch.Tensor:
    """Mean causal-LM cross entropy over unmasked labels (-1 = masked),
    computing logits for ``chunk`` positions at a time. Each chunk is
    recomputed in the backward (``remat.recomputed``, as the reference's
    ``jax.checkpoint`` of its chunk body), so its fp32 logits ``(B, chunk,
    V)`` are never saved: only the running sums and the chunk's inputs.
    ``logits_of(xc, head_c)`` gives a chunk's fp32 logits (by default the
    bf16 product)."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    head_c = head.to(COMPUTE_DTYPE)
    if logits_of is None:
        logits_of = lambda xc, w: torch.einsum("bcd,dv->bcv", xc, w).to(torch.float32)

    def body(loss_sum, count, xc, lc):
        xc, lc = xc.to(COMPUTE_DTYPE), lc.long()
        logits = logits_of(xc, head_c)
        if logit_cap > 0:
            logits = logit_cap * torch.tanh(logits / logit_cap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc.clamp_min(0)[..., None])[..., 0]
        mask = (lc >= 0).to(torch.float32)
        return loss_sum + torch.sum((lse - gold) * mask), count + torch.sum(mask)

    loss_sum = x.new_zeros((), dtype=torch.float32)
    count = x.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, chunk):
        loss_sum, count = recomputed(body, loss_sum, count, x[:, s0:s0 + chunk],
                                     labels[:, s0:s0 + chunk])
    return loss_sum / torch.clamp_min(count, 1.0)


def vocab_parallel_lookup(table: torch.Tensor, ids: torch.Tensor, tp: "tp_lib.TPRun"
                          ) -> torch.Tensor:
    """``embed_lookup`` with this rank's rows of the table (its vocab shard
    ``tp.index``): an id outside them gives a zero row, and the rows are
    summed over the model group (exactly one rank's is not zero, so the sum
    is the one-process lookup, bit for bit)."""
    n = table.shape[0]
    local = ids.long() - tp.index * n
    mine = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table.to(COMPUTE_DTYPE))
    return tp_lib.leave(torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                       device=rows.device)), tp)


def vocab_parallel_cross_entropy(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                                 tp: "tp_lib.TPRun", *, logit_cap: float = 0.0,
                                 chunk: int = 512) -> torch.Tensor:
    """``chunked_cross_entropy`` with this rank's columns of the head (its
    vocab shard ``tp.index``): per chunk the rank's logits (softcap
    elementwise), their max, sum of ``exp`` and the gold logit merged over
    the model group (the max, then sums in ascending model rank), and the
    log-sum-exp formed from them; the mean over unmasked labels as there.
    Each chunk is recomputed in the backward, its three merges with it, on
    every rank of the group (as the reference's checkpointed chunk body
    runs its collectives again under GSPMD)."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    n = head.shape[1]
    x = tp_lib.enter(x, tp)
    head_c = head.to(COMPUTE_DTYPE)
    zero = x.new_zeros((), dtype=torch.float32)

    def body(loss_sum, count, xc, lc):
        xc, lc = xc.to(COMPUTE_DTYPE), lc.long()
        logits = torch.einsum("bcd,dv->bcv", xc, head_c).to(torch.float32)
        if logit_cap > 0:
            logits = logit_cap * torch.tanh(logits / logit_cap)
        top = tp_lib.group_max(torch.amax(logits.detach(), dim=-1), tp)
        sumexp = tp_lib.leave(torch.sum(torch.exp(logits - top[..., None]), dim=-1), tp)
        lse = top + torch.log(sumexp)
        local = lc - tp.index * n
        mine = (local >= 0) & (local < n)
        gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        gold = tp_lib.leave(torch.where(mine, gold, zero), tp)
        mask = (lc >= 0).to(torch.float32)
        return loss_sum + torch.sum((lse - gold) * mask), count + torch.sum(mask)

    loss_sum = x.new_zeros((), dtype=torch.float32)
    count = x.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, chunk):
        loss_sum, count = recomputed(body, loss_sum, count, x[:, s0:s0 + chunk],
                                     labels[:, s0:s0 + chunk])
    return loss_sum / torch.clamp_min(count, 1.0)


def column_parallel_lookup(table: torch.Tensor, ids: torch.Tensor, tp: "tp_lib.TPRun"
                           ) -> torch.Tensor:
    """``embed_lookup`` with this rank's columns of the table (its ``D/M``
    shard of the width, ``tp.index``): each token's columns, joined over the
    model group (``tensor_parallel.collect``; the one-process lookup, bit
    for bit); the gradient is the rank's columns."""
    tp_lib.CALLS["column_parallel_lookup"] += 1
    return tp_lib.collect(embed_lookup(table, ids), tp, -1)


def row_parallel_cross_entropy(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                               tp: "tp_lib.TPRun", *, logit_cap: float = 0.0,
                               chunk: int = 512) -> torch.Tensor:
    """``chunked_cross_entropy`` with this rank's rows of the head (its
    ``D/M`` shard of the width, ``tp.index``): each chunk's logits are the
    fp32 partial products of the rank's columns of ``x`` (one
    ``tensor_parallel.own`` for all chunks), summed over the model group in
    ascending model rank and rounded to the compute type once, as the
    one-process product is; the softcap, the log-sum-exp and the gold logit
    run whole on every rank, so the loss is bit-equal across the group.
    Each chunk is recomputed in the backward, its sum with it."""
    tp_lib.CALLS["row_parallel_cross_entropy"] += 1
    return chunked_cross_entropy(
        tp_lib.own(x, tp), head, labels, logit_cap=logit_cap, chunk=chunk,
        logits_of=lambda xc, w: tp_lib.row_parallel(xc, w, "bcd,dv->bcv", tp,
                                                    COMPUTE_DTYPE).to(torch.float32))

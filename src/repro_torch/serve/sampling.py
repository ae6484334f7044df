"""Token sampling with counter-based Threefry streams.

Port of ``repro/serve/sampling.py``. A request's stream is a pure function
of (engine seed, request id), never of its slot or of the tick:

    request key   = fold_in(PRNGKey(engine seed), request id)
    token noise   = threefry2x32(key words,
                                 counter0 = generated-token index,
                                 counter1 = STREAM_SAMPLE)
    logit uniform = threefry2x32(token noise words,
                                 counter0 = vocab index, counter1 = 0)

Sampling is Gumbel-max, ``argmax(logits / T + G)`` over a per-slot dynamic
top-k support (ties at the threshold admitted); temperature <= 0 is greedy
and top_k <= 0 the full vocabulary. The Threefry words live in int64 torch
tensors masked to 32 bits (``kernels.sr``), so the uniforms are the
reference's bit for bit on any device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import sr
from repro_torch.kernels.sr import STREAM_SAMPLE

__all__ = ["request_key_words", "sample_uniforms", "sample_tokens", "STREAM_SAMPLE"]

_TINY = 1e-12


def request_key_words(seed: int, rid: int) -> Tuple[int, int]:
    """The two 32-bit key words of a request's sampling stream, as host ints
    (derived on the host: no device work)."""
    return sr.fold_in(sr.PRNGKey(seed), int(rid))


def sample_uniforms(kw: torch.Tensor, gen_idx: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V) fp32 uniforms in [0, 1) for slots keyed by ``kw`` (B, 2) int64
    sampling their ``gen_idx`` (B,)-th token."""
    tk0, tk1 = sr.threefry2x32(kw[:, 0], kw[:, 1], gen_idx.to(torch.int64), STREAM_SAMPLE)
    v = torch.arange(vocab, dtype=torch.int64, device=kw.device)[None, :]
    bits, _ = sr.threefry2x32(tk0[:, None], tk1[:, None], v, 0)
    return sr.uniform_from_bits(bits)


def sample_tokens(logits: torch.Tensor, kw: torch.Tensor, gen_idx: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """One token per slot: logits (B, V) fp32, kw (B, 2) int64 key words,
    gen_idx (B,), temperature (B,) fp32 (<= 0 greedy), top_k (B,) (<= 0 full
    vocabulary) -> (B,) int64."""
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    u = sample_uniforms(kw, gen_idx, V)
    gumbel = -torch.log(-torch.log(u + _TINY) + _TINY)
    scaled = logits / torch.clamp_min(temperature, _TINY)[:, None]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_idx = torch.clamp(top_k.to(torch.int64) - 1, 0, V - 1)
    kth = sorted_desc[torch.arange(B, device=logits.device), k_idx]
    allowed = (top_k[:, None] <= 0) | (logits >= kth[:, None])
    noisy = torch.where(allowed, scaled + gumbel, -torch.inf)
    sampled = torch.argmax(noisy, dim=-1)
    return torch.where(temperature > 0, sampled, greedy)

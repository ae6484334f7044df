"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Port of ``repro/models/moe.py`` (``moe_apply``): the one-hot dispatch of
t5x/flaxformer. Tokens go in groups of ``T``; each group dispatches to
per-expert capacity buffers of ``C = T*k*cf/E`` slots, and the expert FFNs
run as batched products over the expert dim. Parameters: ``router (D, E)``,
``w1``/``w3 (E, D, F)``, ``w2 (E, F, D)`` (stacked over layers by
``blocks.MoEStack``).

Routing is discontinuous, so each step rounds as the reference's does:

* router logits from a bf16 product, softmax in fp32;
* top-k by a stable descending sort: the lower expert index first on ties,
  as ``jax.lax.top_k`` (``torch.topk`` promises no order there), then the
  top-k probabilities renormalized;
* slots in token-major priority (a cumulative sum over the flattened
  ``(T*k, E)`` one-hot); assignments at or past ``C`` are dropped;
* combine weights rounded to bf16; the dispatch, the expert outputs' combine
  and their gradients are one-hot products in bf16 with fp32 sums, as the
  reference's einsums, so each token's output is the bf16 rounding of an
  fp32 sum over its kept assignments.

The load-balance loss is Switch's ``E * mean_g(sum_e(frac / T * mean_prob))``;
``frac`` comes from the kept dispatch and carries no gradient.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DTYPE

__all__ = ["moe_capacity", "moe_shard_groups", "moe_slots", "moe_route", "moe_apply"]


def moe_capacity(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float = 1.25,
                 group_size: int = 2048) -> Tuple[int, int]:
    """(group size T, expert capacity C) for ``n_tokens`` tokens."""
    T = min(group_size, n_tokens)
    if n_tokens % T:
        raise ValueError(f"moe: {n_tokens} tokens do not split into groups of {T}")
    C = max(4, int(T * top_k * capacity_factor / n_experts))
    return T, min(C, T)


def moe_shard_groups(n_tokens: int, shards: int, top_k: int, n_experts: int,
                     capacity_factor: float = 1.25, group_size: int = 2048) -> Tuple[int, int]:
    """(group size T, expert capacity C) of a data shard of ``n_tokens``
    tokens, one of ``shards``: the groups are the global batch's, so the
    shard must hold whole groups."""
    T, C = moe_capacity(n_tokens * shards, top_k, n_experts, capacity_factor, group_size)
    if n_tokens % T:
        raise ValueError(f"moe: a data shard of {n_tokens} tokens does not hold whole groups of "
                         f"{T} tokens (the global batch's); give each shard a multiple of {T}")
    return T, C


def moe_slots(top_idx: torch.Tensor, n_experts: int, capacity: int) -> torch.Tensor:
    """Each assignment's slot in its expert's buffer, token-major priority
    (a cumulative sum over the flattened (T*k, E) one-hot), -1 where the
    expert is full: top_idx (G, T, k) -> (G, T, k) int64."""
    G, T, k = top_idx.shape
    flat = F.one_hot(top_idx, n_experts).to(torch.float32).reshape(G, T * k, n_experts)
    pos = torch.sum(torch.cumsum(flat, dim=1) * flat, dim=-1).reshape(G, T, k) - 1.0
    return torch.where(pos < capacity, pos, torch.full_like(pos, -1.0)).to(torch.int64)


def moe_route(router: torch.Tensor, xg: torch.Tensor, top_k: int, capacity: int):
    """Routing of grouped tokens xg (G, T, D) bf16 through ``router`` (D, E):
    (probs (G, T, E) fp32, renormalized top-k probabilities (G, T, k), their
    experts (G, T, k), their slots (G, T, k), -1 where dropped)."""
    logits = torch.einsum("gtd,de->gte", xg, router.to(COMPUTE_DTYPE)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[..., :top_k], idx[..., :top_k]
    top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
    with torch.no_grad():
        slot = moe_slots(top_idx, router.shape[-1], capacity)
    return probs, top_vals, top_idx, slot


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 2048
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D) in x's dtype, fp32 aux loss).

    On a mesh, ``x`` is one data shard of the global batch
    (``sharding.context.batch_shards``): the groups are those of the global
    batch, so the shard must hold whole groups, and the mean of the shards'
    aux losses is the global one."""
    from repro_torch.sharding.context import current_batch_shards

    B, S, D = x.shape
    E = p["router"].shape[-1]
    T, C = moe_shard_groups(B * S, current_batch_shards(), top_k, E, capacity_factor,
                            group_size)
    G = B * S // T
    cd = COMPUTE_DTYPE

    xg = x.reshape(G, T, D).to(cd)
    probs, top_vals, top_idx, slot = moe_route(p["router"], xg, top_k, C)
    with torch.no_grad():
        keep = (slot >= 0).to(cd)[..., None, None]
        pec = (F.one_hot(top_idx, E).to(cd)[..., None]
               * F.one_hot(torch.clamp_min(slot, 0), C).to(cd)[..., None, :] * keep)
        dispatch = torch.sum(pec, dim=2)  # (G, T, E, C), exact: 0 or 1
    # one assignment of a token per expert: the sum over k only places them
    combine = torch.sum(pec * top_vals.to(cd)[..., None, None], dim=2)

    exp_in = torch.einsum("gtec,gtd->egcd", dispatch, xg)
    h = torch.einsum("egcd,edf->egcf", exp_in, p["w1"].to(cd))
    hg = torch.einsum("egcd,edf->egcf", exp_in, p["w3"].to(cd))
    h = F.silu(h) * hg
    exp_out = torch.einsum("egcf,efd->egcd", h, p["w2"].to(cd))
    out = torch.einsum("egcd,gtec->gtd", exp_out, combine)

    # Switch load balance: frac (bf16, as the reference's mean of a bf16
    # dispatch: an fp32 sum, one rounding) / T (bf16) times the fp32 mean_prob
    frac = torch.mean(dispatch.sum(dim=-1).to(torch.float32), dim=1).to(cd)  # (G, E)
    mean_prob = torch.mean(probs, dim=1)  # (G, E)
    aux = E * torch.mean(torch.sum((frac / T) * mean_prob, dim=-1))
    return out.reshape(B, S, D).to(x.dtype), aux

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

On a mesh (the reference's GSPMD layouts, ``sharding.tensor_parallel``):

* the groups are the global batch's (``sharding.context.batch_shards``): a
  data shard's tokens are a contiguous run of the global token order, and
  where a group spans shards each shard places its tokens at their offsets
  in the groups it touches (the other shards' positions hold zeros and
  route nowhere). One gather over the data group brings every shard's
  per-(group, expert) count of routed assignments and sum of
  probabilities: a shard's slots continue the counts of the lower data
  ranks (integers, exact), the kept count of a group is ``min(count, C)``,
  and every shard's aux is the global value, written so that the mean of
  the shards' gradients is the global one's;
* routing, combine and aux run whole on every rank of a model group, which
  holds the same tokens; where the experts are cut on ``model`` (a ``w1``
  with fewer experts than the router) the rank runs its experts' buffers
  and the model group's outputs are gathered back into the whole buffer
  (the gradient: the rank's own rows); where each expert's FFN is cut on
  ``mlp`` (a ``w1`` narrower than ``width``) ``w2``'s partial product is
  summed over the model group. The expert branch's input enters the split
  (its gradient summed over the model group); the router's input does
  not, its gradient being whole on every rank.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DTYPE

__all__ = ["GroupSpan", "moe_capacity", "moe_shard_groups", "moe_slots", "moe_choose",
           "moe_apply"]


def moe_capacity(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float = 1.25,
                 group_size: int = 2048) -> Tuple[int, int]:
    """(group size T, expert capacity C) for ``n_tokens`` tokens."""
    T = min(group_size, n_tokens)
    if n_tokens % T:
        raise ValueError(f"moe: {n_tokens} tokens do not split into groups of {T}")
    C = max(4, int(T * top_k * capacity_factor / n_experts))
    return T, min(C, T)


class GroupSpan(NamedTuple):
    """Where a data shard's tokens lie in the global batch's groups: group
    size ``T``, capacity ``C``, the first group it touches, how many it
    touches, the positions before its first token in that group and after
    its last in the last one, and the global number of groups."""

    T: int
    C: int
    first: int
    count: int
    lead: int
    trail: int
    groups: int

    @property
    def split(self) -> bool:
        """Whether some group it touches spans other shards."""
        return bool(self.lead or self.trail)


def moe_shard_groups(n_tokens: int, shards: int, index: int, top_k: int, n_experts: int,
                     capacity_factor: float = 1.25, group_size: int = 2048) -> GroupSpan:
    """The groups of data shard ``index`` of ``shards``, each of ``n_tokens``
    tokens: the groups are the global batch's, runs of ``T`` of its token
    order, which the shards cut into equal runs in data rank order."""
    total = n_tokens * shards
    T, C = moe_capacity(total, top_k, n_experts, capacity_factor, group_size)
    a, b = index * n_tokens, (index + 1) * n_tokens
    first, last = a // T, -(-b // T)
    return GroupSpan(T, C, first, last - first, a - first * T, last * T - b, total // T)


def moe_slots(top_idx: torch.Tensor, n_experts: int, capacity: int,
              before: Optional[torch.Tensor] = None,
              mine: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each assignment's slot in its expert's buffer, token-major priority
    (a cumulative sum over the flattened (T*k, E) one-hot), -1 where the
    expert is full: top_idx (G, T, k) -> (G, T, k) int64. On a group that
    spans data shards, ``mine`` (G, T) marks this shard's tokens (the others
    route nowhere: -1) and ``before`` (G, E) counts the assignments of the
    lower shards' tokens, which come first."""
    G, T, k = top_idx.shape
    flat = F.one_hot(top_idx, n_experts).to(torch.float32)
    if mine is not None:
        flat = flat * mine[..., None, None].to(torch.float32)
    flat = flat.reshape(G, T * k, n_experts)
    count = torch.cumsum(flat, dim=1)
    if before is not None:
        count = count + before[:, None, :]
    pos = torch.sum(count * flat, dim=-1).reshape(G, T, k) - 1.0  # -1 where unrouted
    return torch.where(pos < capacity, pos, torch.full_like(pos, -1.0)).to(torch.int64)


def moe_choose(router: torch.Tensor, xg: torch.Tensor, top_k: int):
    """The routing choice of grouped tokens xg (G, T, D) bf16 through
    ``router`` (D, E): (probs (G, T, E) fp32, renormalized top-k
    probabilities (G, T, k), their experts (G, T, k))."""
    logits = torch.einsum("gtd,de->gte", xg, router.to(COMPUTE_DTYPE)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[..., :top_k], idx[..., :top_k]
    top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
    return probs, top_vals, top_idx


def _placed(x: torch.Tensor, span: GroupSpan) -> torch.Tensor:
    """A shard's (count, ...) rows of its groups at their place among the
    global batch's groups (zeros elsewhere)."""
    return F.pad(x, (0, 0) * (x.dim() - 1) + (span.first, span.groups - span.first - span.count))


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 2048, width: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D) in x's dtype, fp32 aux loss).
    ``width`` is an expert's whole hidden width (its ``w1`` narrower: the
    rank's mlp columns, under ``sharding.tensor_parallel.use``).

    On a mesh, ``x`` is one data shard of the global batch
    (``sharding.context.batch_shards``): the groups are those of the global
    batch; where they are whole in the shard the shards' aux losses average
    to the global one, where they span shards each shard's aux is it."""
    from repro_torch.comms.collectives import timed_gather
    from repro_torch.sharding import tensor_parallel as tp_lib
    from repro_torch.sharding.context import current_data_shards

    B, S, D = x.shape
    E = p["router"].shape[-1]
    shards = current_data_shards()
    span = moe_shard_groups(B * S, shards.size, shards.index, top_k, E, capacity_factor,
                            group_size)
    T, C, G = span.T, span.C, span.count
    cd = COMPUTE_DTYPE
    tp = tp_lib.current()
    experts = tp is not None and p["w1"].shape[0] != E
    columns = tp is not None and 0 < width != p["w1"].shape[-1]

    flat = x.reshape(B * S, D).to(cd)
    if span.split:
        flat = F.pad(flat, (0, 0, span.lead, span.trail))
    xg = flat.reshape(G, T, D)
    probs, top_vals, top_idx = moe_choose(p["router"], xg, top_k)
    mine = lower = None
    if span.split:
        pos = torch.arange(G * T, device=x.device).reshape(G, T)
        mine = (pos >= span.lead) & (pos < G * T - span.trail)
        # the shard's routed assignments and probability sums per (group,
        # expert), every shard's at once
        own_probs = torch.sum(probs * mine[..., None].to(probs.dtype), dim=1)  # (G, E)
        with torch.no_grad():
            counts = F.one_hot(top_idx, E).to(torch.float32).mul_(
                mine[..., None, None].to(torch.float32)).sum(dim=(1, 2))
            stats = torch.stack([counts, own_probs.detach()], dim=1)  # (G, 2, E)
            # (shards, groups, 2, E)
            every = timed_gather(_placed(stats, span), shards.group, shards.world)
            lower = every[:shards.index, span.first:span.first + G, 0].sum(dim=0)
    with torch.no_grad():
        slot = moe_slots(top_idx, E, C, before=lower, mine=mine)
        keep = (slot >= 0).to(cd)[..., None, None]
        pec = (F.one_hot(top_idx, E).to(cd)[..., None]
               * F.one_hot(torch.clamp_min(slot, 0), C).to(cd)[..., None, :] * keep)
        dispatch = torch.sum(pec, dim=2)  # (G, T, E, C), exact: 0 or 1
    # one assignment of a token per expert: the sum over k only places them
    combine = torch.sum(pec * top_vals.to(cd)[..., None, None], dim=2)

    xe = tp_lib.enter(xg, tp) if experts or columns else xg
    if experts:  # the rank's experts
        n = p["w1"].shape[0]
        dispatch_e = dispatch[:, :, tp.index * n:(tp.index + 1) * n]
    else:
        dispatch_e = dispatch
    exp_in = torch.einsum("gtec,gtd->egcd", dispatch_e, xe)
    h = torch.einsum("egcd,edf->egcf", exp_in, p["w1"].to(cd))
    hg = torch.einsum("egcd,edf->egcf", exp_in, p["w3"].to(cd))
    h = F.silu(h) * hg
    if columns:
        exp_out = tp_lib.row_parallel(h, p["w2"], "egcf,efd->egcd", tp, cd)
    else:
        exp_out = torch.einsum("egcf,efd->egcd", h, p["w2"].to(cd))
    if experts:
        exp_out = tp_lib.collect(exp_out, tp)
    out = torch.einsum("egcd,gtec->gtd", exp_out, combine)
    if span.split:
        out = out.reshape(G * T, D)[span.lead:G * T - span.trail]

    # Switch load balance: frac (bf16, as the reference's mean of a bf16
    # dispatch: an fp32 sum, one rounding) / T (bf16) times the fp32 mean_prob
    if not span.split:
        frac = torch.mean(dispatch.sum(dim=-1).to(torch.float32), dim=1).to(cd)  # (G, E)
        mean_prob = torch.mean(probs, dim=1)  # (G, E)
    else:
        # every group of the global batch: its kept assignments (the first C
        # of its count) and its probability sum, with the gradient of this
        # shard's part scaled by the shards, whose gradients are averaged
        total = every[:, :, 0].sum(dim=0)
        frac = (torch.clamp_max(total, C) / T).to(cd)
        own = _placed(own_probs, span)
        scale = torch.full((), float(shards.size), dtype=own.dtype, device=own.device)
        mean_prob = (every[:, :, 1].sum(dim=0) + (own - own.detach()) * scale) / T
    aux = E * torch.mean(torch.sum((frac / T) * mean_prob, dim=-1))
    return out.reshape(B, S, D).to(x.dtype), aux

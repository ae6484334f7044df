"""The collectives of the mesh path, over ``torch.distributed``.

The backend rule: NCCL when each rank has a card of its own; gloo on the
CPU and when ranks share a card. gloo takes no CUDA tensor for these
collectives, so under gloo a CUDA tensor goes through host memory: it is
copied to the host, moved, and copied back (``through_host`` says whether
a group does this). That is the wire's cost on such a run, not a fallback:
the compute stays on the card.

``all_gather`` stacks every rank's tensor in rank order (equal shapes);
``all_to_all`` sends piece ``j`` of a ``(n, ...)`` tensor to the group's
``j``-th rank and returns the ``(n, ...)`` pieces it received, in the
group's rank order.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

__all__ = ["through_host", "all_gather", "all_to_all", "merge_max"]


def through_host(t: torch.Tensor, group=None) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``(world, *t.shape)``: every rank's ``t`` in rank order."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    dev = src.device
    if through_host(src, group):
        src = src.cpu()
    out = torch.empty((n,) + tuple(src.shape), dtype=src.dtype, device=src.device)
    with warnings.catch_warnings():  # all_gather_into_tensor's rename notice
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out.reshape(-1), src.reshape(-1), group=group)
    return out.to(dev)


def all_to_all(pieces: torch.Tensor, group=None) -> torch.Tensor:
    """Piece ``j`` to rank ``j`` of ``group``; returns what each sent here."""
    src = pieces.contiguous()
    dev = src.device
    if through_host(src, group):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(dev)


def merge_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max of ``x`` over the ranks of ``group``, NaN-propagating
    (``torch.amax`` over the gathered copies; gloo's MAX is not)."""
    return torch.amax(all_gather(x, group), dim=0)

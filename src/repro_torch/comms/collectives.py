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

Under gloo, once the world has called ``open_host_slots()``, a payload of
at least ``HOST_MIN_BYTES`` moves through shared memory (``HostSlots``):
each process writes into a slot of its own, the group meets at a barrier,
each reads what it needs from the others' slots, and the group meets again
before a slot is written anew (payloads larger than a slot go in chunks).
gloo's TCP loopback moved ~0.3 GB/s between two processes of a CPU host,
the slots move at memory copy speed; the bytes delivered are the same. A
world that has not opened slots (or found no room for them in
``/dev/shm``) keeps gloo's own transport. Slots are for the processes of
one host: ranks on several hosts each have a card, and NCCL's path.

``STATS`` holds the host seconds and result bytes of the collectives that
the mesh step runs through ``timed`` since its last reset (the CLI's and
the smoke's step-time split; ``train.mesh.MeshStep.reckon`` gives a
step's bytes without a world).

Two contexts serve the roofline (``repro_torch.roofline``):

* ``recording()`` yields a list that every collective call appends its
  ``(kind, result bytes, group size)`` to while the context is open:
  ``all_gather``, ``merge_max`` and ``merge_sum`` (each an all-gather) as
  ``all-gather``, ``all_to_all`` as ``all-to-all``
  (``roofline.analysis.collective_bytes`` prices them). With no context
  open a call pays one test of an empty list.
* ``without_world(world)``: the calls move nothing and return empty tensors
  of their results' shapes (``meta`` in, ``meta`` out), so the mesh step's
  layouts can be walked with no process group; a group is then a
  ``Ranks`` tuple (``None``: the ``world`` ranks).
"""

from __future__ import annotations

import contextlib
import contextvars
import mmap
import os
import socket
import time
import uuid
import warnings
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["STATS", "timed", "through_host", "all_gather", "timed_gather", "all_to_all",
           "merge_max", "merge_sum", "Ranks", "recording", "without_world", "open_host_slots",
           "close_host_slots", "HOST_MIN_BYTES", "HOST_SLOT_BYTES"]

Call = Tuple[str, int, int]  # (kind, result bytes, group size)
# the open recordings, innermost last: module state, not a context
# variable, so the collectives of a backward pass that autograd runs on its
# own thread are recorded too
_RECORDS: List[List[Call]] = []
_DRY_WORLD: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "repro_collective_dry_world", default=None)


# host seconds and result bytes of the collectives run through ``timed``
# since the last reset (read by the CLI and the smoke's step-time split)
STATS = {"collective_s": 0.0, "bytes": 0}


def timed(fn, *args):
    """``fn(*args)`` (a collective), its host seconds and its result's
    bytes added to ``STATS``."""
    t0 = time.perf_counter()
    out = fn(*args)
    STATS["collective_s"] += time.perf_counter() - t0
    STATS["bytes"] += out.numel() * out.element_size()
    return out


class Ranks(tuple):
    """A process group's ranks, standing in for the group without a world."""


@contextlib.contextmanager
def recording() -> Iterator[List[Call]]:
    """Within it, every collective appends its ``(kind, result bytes, group
    size)`` to the yielded list (the innermost open one)."""
    calls: List[Call] = []
    _RECORDS.append(calls)
    try:
        yield calls
    finally:
        _RECORDS.remove(calls)


def _record(kind: str, out: torch.Tensor, group_size: int) -> None:
    if _RECORDS:
        _RECORDS[-1].append((kind, out.numel() * out.element_size(), int(group_size)))


@contextlib.contextmanager
def without_world(world: int) -> Iterator[None]:
    """Within it, collectives move nothing and return empty results of the
    right shapes (the layout reckoning of ``train.mesh.MeshStep``)."""
    token = _DRY_WORLD.set(int(world))
    try:
        yield
    finally:
        _DRY_WORLD.reset(token)


def _size(group) -> int:
    dry = _DRY_WORLD.get()
    if dry is None:
        return dist.get_world_size(group)
    return dry if group is None else len(group)


def through_host(t: torch.Tensor, group=None) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


# payloads from this size up go through the host's shared memory (smaller
# ones are latency-bound: gloo's one call beats two barriers)
HOST_MIN_BYTES = 1 << 20
HOST_SLOT_BYTES = 256 << 20


class HostSlots:
    """The world's slots in ``/dev/shm``, one a process, each mapped into
    every process. ``open`` makes them: each process creates its file,
    publishes its path in the world's store, maps its peers' files, and
    after a barrier that says every process has mapped every file, unlinks
    its own, so the pages live as long as the mappings and nothing is left
    behind, whatever ends the processes."""

    def __init__(self):
        self.store = None  # the world the slots were opened for
        self.chunk = 0
        self.slots: List[torch.Tensor] = []  # uint8, by world rank

    @staticmethod
    def _map(path: str, size: int, create: bool) -> torch.Tensor:
        fd = os.open(path, os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0), 0o600)
        try:
            if create:
                os.ftruncate(fd, size)
            return torch.frombuffer(mmap.mmap(fd, size), dtype=torch.uint8)
        finally:
            os.close(fd)

    def open(self, nbytes: int) -> bool:
        self.close()
        if dist.get_backend() != "gloo":
            return False
        store = dist.distributed_c10d._get_default_store()
        rank, world = dist.get_rank(), dist.get_world_size()
        room = 0
        if os.path.isdir("/dev/shm"):
            free = os.statvfs("/dev/shm")
            room = free.f_bavail * free.f_frsize // (4 * world)
        size = min(int(nbytes), room)
        path, mine = f"/dev/shm/repro_{os.getpid()}_{uuid.uuid4().hex[:12]}", None
        try:
            if size >= HOST_MIN_BYTES:
                mine = self._map(path, size, create=True)
            store.set(f"repro_host_slot/{rank}",
                      f"{socket.gethostname()}|{path if mine is not None else ''}|{size}")
            dist.barrier()
            entries = [store.get(f"repro_host_slot/{r}").decode().split("|")
                       for r in range(world)]
            if len({host for host, _, _ in entries}) != 1:
                raise RuntimeError("host slots: the world's processes are on several hosts")
            slots = None
            if all(p for _, p, _ in entries):
                slots = [mine if r == rank else self._map(p, int(n), create=False)
                         for r, (_, p, n) in enumerate(entries)]
            dist.barrier()  # every process has mapped every slot
        finally:
            if mine is not None:
                os.unlink(path)
        if slots is None:
            return False
        self.store, self.slots = store, slots
        self.chunk = min(int(n) for _, _, n in entries)
        return True

    def close(self) -> None:
        self.store, self.chunk, self.slots = None, 0, []

    def plan(self, group) -> Optional[Tuple[int, List[torch.Tensor]]]:
        """(chunk bytes, the group's slots in group rank order), or None
        where the world has no slots open."""
        if self.store is None or self.store is not dist.distributed_c10d._get_default_store():
            return None
        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else range(dist.get_world_size()))
        return self.chunk, [self.slots[r] for r in ranks]


_SLOTS = HostSlots()


def open_host_slots(nbytes: int = HOST_SLOT_BYTES) -> bool:
    """Collective over the world (every rank, right after
    ``init_process_group``): open the slots of ``nbytes`` each (less where
    ``/dev/shm`` has less room) that carry gloo's payloads from
    ``HOST_MIN_BYTES`` up. False where the world keeps gloo's transport
    (another backend, or no room); raises where the processes are on
    several hosts."""
    return _SLOTS.open(nbytes)


def close_host_slots() -> None:
    """Drop this process's mappings; its collectives take gloo's transport."""
    _SLOTS.close()


def _host_plan(src: torch.Tensor, group):
    """The shared-memory plan for ``src`` in ``group``, if it takes one."""
    nbytes = src.numel() * src.element_size()
    if nbytes < HOST_MIN_BYTES or dist.get_backend(group) != "gloo":
        return None
    return _SLOTS.plan(group)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``(world, *t.shape)``: every rank's ``t`` in rank order."""
    n = _size(group)
    src = t.contiguous()
    if _DRY_WORLD.get() is not None:
        out = src.new_empty((n,) + tuple(src.shape))
        _record("all-gather", out, n)
        return out
    plan = _host_plan(src, group)
    if plan is not None:
        chunk, slots = plan
        me = dist.get_rank(group)
        out = torch.empty((n,) + tuple(src.shape), dtype=src.dtype, device=src.device)
        data, got = _as_bytes(src), out.reshape(n, -1).view(torch.uint8)
        for off in range(0, data.numel(), chunk):
            m = min(chunk, data.numel() - off)
            slots[me][:m].copy_(data[off:off + m])
            dist.barrier(group=group)
            for j in range(n):
                got[j, off:off + m].copy_(slots[j][:m])
            dist.barrier(group=group)
        _record("all-gather", out, n)
        return out
    dev = src.device
    if through_host(src, group):
        src = src.cpu()
    out = torch.empty((n,) + tuple(src.shape), dtype=src.dtype, device=src.device)
    with warnings.catch_warnings():  # all_gather_into_tensor's rename notice
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out.reshape(-1), src.reshape(-1), group=group)
    _record("all-gather", out, n)
    return out.to(dev)


def timed_gather(t: torch.Tensor, group, world: Optional[int] = None) -> torch.Tensor:
    """``all_gather(t, group)`` through ``timed``, run ``without_world(world)``
    where ``world`` is set (a split step reckoned or measured on ``meta``)."""
    with without_world(world) if world is not None else contextlib.nullcontext():
        return timed(all_gather, t, group)


def all_to_all(pieces: torch.Tensor, group=None) -> torch.Tensor:
    """Piece ``j`` to rank ``j`` of ``group``; returns what each sent here."""
    src = pieces.contiguous()
    if _DRY_WORLD.get() is not None:
        out = torch.empty_like(src)
        _record("all-to-all", out, _size(group))
        return out
    plan = _host_plan(src, group)
    if plan is not None:
        chunk, slots = plan
        n, me = src.shape[0], dist.get_rank(group)
        out = torch.empty_like(src)
        data, got = src.reshape(n, -1).view(torch.uint8), out.reshape(n, -1).view(torch.uint8)
        step = max(1, chunk // n)  # bytes of each piece a round
        for off in range(0, data.shape[1], step):
            m = min(step, data.shape[1] - off)
            slots[me][:n * m].view(n, m).copy_(data[:, off:off + m])
            dist.barrier(group=group)
            for j in range(n):
                got[j, off:off + m].copy_(slots[j][me * m:(me + 1) * m])
            dist.barrier(group=group)
        _record("all-to-all", out, _size(group))
        return out
    dev = src.device
    if through_host(src, group):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _record("all-to-all", out, _size(group))
    return out.to(dev)


def merge_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max of ``x`` over the ranks of ``group``, NaN-propagating
    (``torch.amax`` over the gathered copies; gloo's MAX is not)."""
    return torch.amax(all_gather(x, group), dim=0)


def merge_sum(x: torch.Tensor, group=None, take: Optional[Tuple[int, ...]] = None
              ) -> torch.Tensor:
    """Elementwise sum of ``x`` over the ranks of ``group``, added in
    ascending rank order, so every rank holds the same bits (NaN
    propagates). ``take`` lists the group positions whose partials count
    (ascending; all if None): where several ranks hold the same box of a
    leaf, only one of them may count it."""
    every = all_gather(x, group)
    take = range(every.shape[0]) if take is None else take
    out = None
    for i in take:
        out = every[i].clone() if out is None else out.add_(every[i])
    return out

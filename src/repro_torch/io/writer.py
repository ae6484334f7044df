"""Checkpoint writer: host snapshot + background serialisation (port of
``repro/io/writer.py``).

``snapshot_tree`` is the blocking part of a save: every part this process
writes is copied to the host through ``_device_to_host``, and the copies are
finished when it returns, so the train step that follows (which updates the
params in place) cannot change what is being saved. On a mesh
(``shardings=``, ``mesh=``) every tensor of the state is the rank's part of
a leaf under the plan: the manifest records the whole shape, the rank's
index records its box as ranges of the whole leaf, and a box that several
ranks hold (a leaf replicated over the mesh or over ``model``) is written
once, by the lowest of them, as the reference writes only ``replica_id ==
0``. ``write_snapshot`` serialises host buffers only: it touches no CUDA,
so it can run on the writer thread while the train loop keeps issuing
steps (``hashlib`` and file writes release the GIL).

``AsyncCheckpointWriter`` double-buffers: ``save()`` blocks on the snapshot,
hands the buffers to a background thread for serialisation + fsync +
COMMIT, and blocks only when a third save arrives while two are in flight.

The commit protocol is the reference's, for one process or several. The
processes meet through the checkpoint directory only, never a
``torch.distributed`` collective, which on the writer thread could
interleave with the train step's and deadlock:
  1. process 0 purges crashed attempts at the step, makes an
     attempt-unique staging dir (``step_X.attempt_<nonce>``) and advertises
     it through an atomically replaced pointer file; the others wait for
     the pointer;
  2. every process writes and fsyncs its ``host_<p>.bin`` into the stage,
     then publishes ``index_host_<p>.json`` (temp + ``os.replace``: the
     index exists only once its bin is durable); process 0 also writes
     ``manifest.json`` (``num_hosts`` = the process count);
  3. process 0 waits for every index, writes ``COMMIT`` in the stage,
     swaps the stage into ``step_X`` (a committed copy of the step is set
     aside until then) and updates LATEST; every other process returns once
     its stage has been swapped in and COMMIT is visible.
The ``_barrier`` seams name the phases for crash injection; the
``ckpt_written`` seam lies between a process's fsynced bin and its index,
so a process that dies there leaves the step without COMMIT.
"""

from __future__ import annotations

import glob
import json
import os
import queue
import shutil
import threading
import time
import uuid
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.io import format as fmt
from repro_torch.io.legacy import save_checkpoint_npz
from repro_torch.io.tree import flatten_with_keys, plan_of, structure_repr
from repro_torch.sharding.rules import mesh_axis_sizes
from repro_torch.sharding.specs import local_box, mesh_coords, whole_shape

__all__ = ["Snapshot", "snapshot_tree", "write_snapshot", "save_checkpoint",
           "AsyncCheckpointWriter"]

# tensors whose dtype numpy lacks travel as raw words of the same width
_WORD_VIEW = {torch.bfloat16: torch.uint16}


def _device_to_host(key: str, leaf) -> np.ndarray:
    """Host copy of one part this process writes, in its storage dtype.
    Every device-to-host byte the writer moves goes through here (the spy
    tests patch it). It is always a copy (of a CPU tensor too, whose storage
    the next step updates in place), and it has finished when this
    returns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.view(_WORD_VIEW.get(t.dtype, t.dtype))
        out = torch.empty(t.shape, dtype=t.dtype)
        out.copy_(t)
        return out.numpy()
    return np.array(leaf, order="C")


_RENDEZVOUS_TIMEOUT_S = 600.0


def _barrier(name: str) -> None:
    """Commit-protocol phase boundary: a named seam so tests can inject
    crashes at protocol points. Deliberately no collective (see the module
    doc)."""


def _await(predicate, what: str) -> None:
    """Poll the checkpoint directory until ``predicate()`` holds."""
    deadline = time.monotonic() + _RENDEZVOUS_TIMEOUT_S
    while not predicate():
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint rendezvous timed out: {what}")
        time.sleep(0.05)


class _LeafSnapshot:
    __slots__ = ("key", "shape", "dtype", "shards")

    def __init__(self, key, shape, dtype: str, shards):
        self.key = key
        self.shape = tuple(int(d) for d in shape)  # the whole leaf's
        self.dtype = dtype  # manifest dtype name
        # [(index ranges, host array)]: the shards this process writes
        self.shards: List[Tuple[List[Tuple[int, int]], np.ndarray]] = shards


class Snapshot:
    """Host-side copy of the parts this process writes, ready to serialise."""

    def __init__(self, leaves: List[_LeafSnapshot], structure: str):
        self.leaves = leaves
        self.structure = structure


def snapshot_tree(tree: Any, shardings: Any = None, mesh=None) -> Snapshot:
    """Blocking part of a save: host copies of the parts this process writes.

    Without ``shardings`` every leaf is whole and process 0 writes it. With
    a plan of ``tree`` (a ``P`` at every tensor, as
    ``train_loop.train_state_shardings`` gives) and its ``mesh``, every
    tensor is this rank's part of its leaf, written by the lowest rank that
    holds the same box. A ``TrainState``'s step and key are whole, written
    by process 0."""
    rank = fmt.process_index()
    parts = plan_of(tree, shardings) if shardings is not None else {}
    if parts:
        sizes = mesh_axis_sizes(mesh)
        coords = mesh_coords(sizes)
        if len(coords) != fmt.process_count():
            raise ValueError(f"a plan over a mesh of {len(coords)} ranks, saved by "
                             f"{fmt.process_count()} processes")
    leaves = []
    for key, leaf in flatten_with_keys(tree):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        box, writer = tuple((0, int(d)) for d in shape), 0
        spec = parts.get(id(leaf))
        if spec is not None:
            shape = whole_shape(shape, spec, sizes)
            boxes = [local_box(spec, shape, c, sizes) for c in coords]
            box, writer = boxes[rank], boxes.index(boxes[rank])
        shards = [(list(box), _device_to_host(key, leaf))] if writer == rank else []
        leaves.append(_LeafSnapshot(key, shape, fmt.dtype_name(leaf), shards))
    return Snapshot(leaves, structure_repr(tree))


def _fsync_write_json(path: str, obj) -> None:
    """Durable JSON whose existence implies complete content."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_snapshot(directory: str, step: int, snap: Snapshot,
                   extra: Optional[Dict] = None) -> str:
    """Serialise a snapshot: this process's shard file and index, and from
    process 0 the manifest and COMMIT, staged in ``step_X.attempt_<nonce>``
    and swapped into ``step_X`` once COMMIT is inside. A committed copy of
    the step stays durable for the whole serialisation; the one vulnerable
    instant, between the two final renames, is what
    ``repair_interrupted_resaves`` covers. A process acting on a stale
    attempt pointer can only time out, never join another attempt's
    commit."""
    os.makedirs(directory, exist_ok=True)
    final = fmt.step_dir(directory, step)
    backup = final + ".replaced"  # matches no step_* name: invisible to list_steps
    p, nprocs = fmt.process_index(), fmt.process_count()
    ptr = os.path.join(directory, f".attempt_step_{step:08d}")
    if p == 0:
        # purge crashed attempts at this step before advertising a new stage:
        # a process that latched onto a stale one would starve the rendezvous
        if os.path.exists(ptr):
            os.remove(ptr)
        for stale in glob.glob(glob.escape(final) + ".attempt_*"):
            shutil.rmtree(stale, ignore_errors=True)
        stage = final + f".attempt_{uuid.uuid4().hex[:8]}"
        os.makedirs(stage)
        if nprocs > 1:
            tmp = ptr + ".tmp"
            with open(tmp, "w") as f:
                f.write(os.path.basename(stage))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, ptr)
    else:

        def _resolve():
            try:
                with open(ptr) as f:
                    name = f.read().strip()
            except OSError:
                return None
            s = os.path.join(directory, name)
            return s if name and os.path.isdir(s) else None

        _await(lambda: _resolve() is not None, f"stage dir for step {step}")
        stage = _resolve()
    _barrier(f"ckpt_prepare_{step}")

    offset = 0
    index: Dict[str, Any] = {"process": p, "shards": {}}
    with open(os.path.join(stage, fmt.shard_file(p)), "wb") as f:
        for leaf in snap.leaves:
            recs = []
            for ranges, arr in leaf.shards:
                buf = arr.reshape(-1).view(np.uint8)  # zero-copy bytes of the host array
                f.write(buf)
                recs.append({"offset": offset, "nbytes": len(buf),
                             "index": [list(r) for r in ranges], "sha256": fmt.sha_bytes(buf)})
                offset += len(buf)
            if recs:
                index["shards"][leaf.key] = recs
        f.flush()
        os.fsync(f.fileno())
    _barrier(f"ckpt_written_{step}")
    # the index lands after its bin is fsynced: once visible, the bytes are durable
    _fsync_write_json(os.path.join(stage, fmt.index_file(p)), index)
    if p != 0:
        # success here must mean durability, as on process 0: wait until
        # process 0 has swapped this stage into place (its name vanishes at
        # the swap) and the committed step is visible
        _await(lambda: not os.path.isdir(stage)
               and os.path.exists(os.path.join(final, fmt.COMMIT)),
               f"commit of step {step}")
        return final
    manifest = {
        "format_version": fmt.FORMAT_VERSION,
        "step": step,
        "extra": extra or {},
        "structure": snap.structure,
        "num_hosts": nprocs,
        "leaves": [{"key": leaf.key, "shape": list(leaf.shape), "dtype": leaf.dtype}
                   for leaf in snap.leaves],
    }
    _fsync_write_json(os.path.join(stage, fmt.MANIFEST), manifest)
    if nprocs > 1:
        _await(lambda: len(glob.glob(os.path.join(glob.escape(stage), "index_host_*.json")))
               >= nprocs, f"all {nprocs} processes' index files for step {step}")
    with open(os.path.join(stage, fmt.COMMIT), "w") as f:
        f.write(f"step {step}\n")
        f.flush()
        os.fsync(f.fileno())
    # swap into place; a committed copy stays durable until the replacement
    # (COMMIT included) is on disk
    with fmt.swap_lock:
        if os.path.exists(final):
            if fmt.is_complete(final):
                if os.path.exists(backup):
                    shutil.rmtree(backup)
                os.rename(final, backup)
            else:
                shutil.rmtree(final)  # crash leftover
        os.rename(stage, final)
        fmt.write_latest(directory, step)
        if os.path.exists(backup):
            shutil.rmtree(backup, ignore_errors=True)
    if nprocs > 1:
        try:
            os.remove(ptr)
        except OSError:
            pass
    return final


def save_checkpoint(directory: str, step: int, tree: Any, extra: Optional[Dict] = None, *,
                    fmt_version: str = "sharded", shardings: Any = None, mesh=None) -> str:
    """Synchronous save: ``"sharded"`` (default) writes format v2 (on a mesh:
    ``shardings``, ``mesh`` as ``snapshot_tree`` takes them), ``"npz"`` the
    legacy v1 single file (migration tooling and format tests)."""
    if fmt_version == "npz":
        return save_checkpoint_npz(directory, step, tree, extra)
    return write_snapshot(directory, step, snapshot_tree(tree, shardings, mesh), extra)


class AsyncCheckpointWriter:
    """Double-buffered background writer.

    ``save()`` = snapshot (blocking, device to host) + enqueue; one worker
    thread serialises in save order, so LATEST only moves forward. At most
    two snapshots are in flight. Worker errors surface on the next
    ``save()``/``wait()``. ``commit_times[step]`` is the ``perf_counter()``
    at which that step's COMMIT landed.
    """

    def __init__(self, directory: str, on_commit: Optional[Callable[[int], None]] = None):
        self.directory = directory
        self.commit_times: Dict[int, float] = {}
        self._on_commit = on_commit
        self._queue: "queue.Queue" = queue.Queue()
        self._slots = threading.Semaphore(2)  # the two buffers
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._worker, name="ckpt-writer", daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            step, snap, extra = self._queue.get()
            try:
                write_snapshot(self.directory, step, snap, extra)
                self.commit_times[step] = time.perf_counter()
                try:
                    if self._on_commit is not None:
                        self._on_commit(step)
                except Exception as e:
                    # the save is durable (COMMIT landed); a failed GC pass
                    # must not report it as failed
                    warnings.warn(f"checkpoint post-commit hook failed: {e!r}")
            except BaseException as e:  # surfaced on the next save()/wait()
                if self._error is None:  # the first failure wins
                    self._error = e
            finally:
                del snap
                self._slots.release()
                self._queue.task_done()

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None, block: bool = False,
             shardings: Any = None, mesh=None):
        self._raise_pending()
        self._ensure_thread()
        self._slots.acquire()  # waits only if two saves are already in flight
        try:
            snap = snapshot_tree(tree, shardings, mesh)  # the only device-blocking work
        except BaseException:
            self._slots.release()  # a failed snapshot must not leak its buffer
            raise
        self._queue.put((step, snap, extra))
        if block:
            self.wait()

    def wait(self):
        self._queue.join()
        self._raise_pending()

"""Checkpoint format v2: per-host shard files + global manifest + COMMIT.

Port of ``repro/io/format.py``; the same bytes on disk, so either package
reads what the other wrote. One step:

    <dir>/step_00000100/
        host_00000.bin          # this process's shard bytes, concatenated
        index_host_00000.json   # per shard: leaf key, offset, nbytes,
                                #   index ranges, sha256 (first 16 hex digits)
        manifest.json           # step, extra, structure, per-leaf
                                #   {key, shape, dtype}, num_hosts
        COMMIT                  # written last: a dir without it is incomplete
    <dir>/LATEST                # advisory pointer (see latest_step)

``manifest.json["format_version"]`` switches the reader; the legacy v1
``arrays.npz`` format stays readable (``legacy.py``). A leaf may have several
shards, each with half-open ``[start, stop)`` ranges per dim of the whole
array, as a checkpoint saved on a mesh has: each process writes its own bin
and index (``host_<p>.bin``, ``index_host_<p>.json``) and process 0 the
manifest and COMMIT. The process index and count are ``torch.distributed``'s
rank and world size when it is initialised, else 0 and 1.

bfloat16 leaves are stored as raw 16-bit words under the name
``bfloat16``, as the reference stores them; numpy has no such dtype, so
``dtype_from_str`` gives the storage dtype and ``torch_dtype`` the
tensor's.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "FORMAT_VERSION",
    "MANIFEST",
    "COMMIT",
    "LATEST",
    "process_index",
    "process_count",
    "shard_file",
    "index_file",
    "step_dir",
    "parse_step",
    "list_steps",
    "latest_step",
    "is_complete",
    "repair_interrupted_resaves",
    "read_manifest",
    "read_shard_index",
    "merged_shard_index",
    "write_latest",
    "sha_bytes",
    "dtype_from_str",
    "dtype_name",
    "torch_dtype",
]

FORMAT_VERSION = 2
MANIFEST = "manifest.json"
COMMIT = "COMMIT"
LATEST = "LATEST"
_STEP_RE = re.compile(r"^step_(\d{8})$")

# Serialises the writer's final stage -> step_X swap against
# repair_interrupted_resaves (which may run from any thread via
# latest_step). In-process only; across processes the COMMIT protocol holds.
swap_lock = threading.Lock()

# dtypes numpy lacks: manifest name -> (storage dtype, torch dtype)
_WORD_DTYPES = {"bfloat16": (np.dtype(np.uint16), torch.bfloat16)}


def process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def shard_file(process: int) -> str:
    return f"host_{process:05d}.bin"


def index_file(process: int) -> str:
    return f"index_host_{process:05d}.json"


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def parse_step(name: str) -> Optional[int]:
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def sha_bytes(buf) -> str:
    return hashlib.sha256(buf).hexdigest()[:16]


def dtype_from_str(s: str) -> np.dtype:
    """Storage dtype of a manifest dtype name (raw words for bfloat16, which
    numpy lacks)."""
    if s in _WORD_DTYPES:
        return _WORD_DTYPES[s][0]
    return np.dtype(s)


def torch_dtype(s: str) -> torch.dtype:
    """The tensor dtype of a manifest dtype name."""
    if s in _WORD_DTYPES:
        return _WORD_DTYPES[s][1]
    return torch.from_numpy(np.zeros(0, np.dtype(s))).dtype


def dtype_name(leaf) -> str:
    """Manifest dtype name of a tensor, numpy array or scalar."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


# ---------------------------------------------------------------------------
# manifest / index readers
# ---------------------------------------------------------------------------


def read_manifest(d: str) -> Dict[str, Any]:
    with open(os.path.join(d, MANIFEST)) as f:
        return json.load(f)


def read_shard_index(d: str, process: int) -> Dict[str, Any]:
    with open(os.path.join(d, index_file(process))) as f:
        return json.load(f)


def merged_shard_index(d: str) -> Dict[str, List[Dict[str, Any]]]:
    """leaf key -> shard records from every host's index file; each record
    carries ``file``, ``offset``, ``nbytes``, ``index`` and ``sha256``."""
    merged: Dict[str, List[Dict[str, Any]]] = {}
    for p in sorted(glob.glob(os.path.join(glob.escape(d), "index_host_*.json"))):
        with open(p) as f:
            idx = json.load(f)
        fname = shard_file(idx["process"])
        for key, shards in idx["shards"].items():
            for s in shards:
                rec = dict(s)
                rec["file"] = fname
                merged.setdefault(key, []).append(rec)
    return merged


# ---------------------------------------------------------------------------
# completeness / step discovery
# ---------------------------------------------------------------------------


def is_complete(d: str) -> bool:
    """A step dir is restorable: v2 needs COMMIT plus one index file per
    host; a legacy v1 dir needs its arrays.npz."""
    mpath = os.path.join(d, MANIFEST)
    if not os.path.exists(mpath):
        return False
    try:
        manifest = read_manifest(d)
    except (OSError, ValueError):
        return False
    if manifest.get("format_version", 1) < 2:
        return os.path.exists(os.path.join(d, "arrays.npz"))
    if not os.path.exists(os.path.join(d, COMMIT)):
        return False
    n_idx = len(glob.glob(os.path.join(glob.escape(d), "index_host_*.json")))
    return n_idx == int(manifest.get("num_hosts", 1))


def list_steps(directory: str, complete_only: bool = True) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        s = parse_step(name)
        if s is None:
            continue
        if complete_only and not is_complete(os.path.join(directory, name)):
            continue
        steps.append(s)
    return sorted(steps)


def _repairable(directory: str) -> List[Tuple[str, str]]:
    """(set-aside copy, its step dir) pairs left by re-saves."""
    out = []
    for name in os.listdir(directory):
        if not name.endswith(".replaced"):
            continue
        base = name[: -len(".replaced")]
        if parse_step(base) is None:
            continue
        out.append((os.path.join(directory, name), os.path.join(directory, base)))
    return out


def repair_interrupted_resaves(directory: str) -> None:
    """Put durable copies back after a crashed re-save.

    Re-saving a committed step renames it to ``step_X.replaced`` until the
    replacement commits; a kill in between leaves a complete backup next to
    an incomplete ``step_X``. Restore the backup (and drop stale backups
    whose replacement did land). Process 0 repairs; every other process
    waits until nothing repairable remains, so every process's step scan
    that follows sees the same complete steps."""
    if not os.path.isdir(directory):
        return
    if process_index() != 0:
        deadline = time.monotonic() + 600.0
        while any(is_complete(b) for b, _ in _repairable(directory)):
            if time.monotonic() > deadline:
                raise TimeoutError("waiting for process 0 to repair interrupted re-saves in "
                                   f"{directory}")
            time.sleep(0.05)
        return
    with swap_lock:
        for bdir, ddir in _repairable(directory):
            if not is_complete(bdir):
                continue  # the backup itself is unusable; leave it for inspection
            if is_complete(ddir):
                shutil.rmtree(bdir, ignore_errors=True)  # the replacement landed
            else:
                if os.path.exists(ddir):
                    shutil.rmtree(ddir)
                os.rename(bdir, ddir)


def latest_step(directory: str) -> Optional[int]:
    """Newest complete step. The LATEST pointer is only a fast path: if it
    names a step whose dir fails the completeness check (a save killed
    mid-shard-write), fall back to the newest complete dir. Crashed re-saves
    are repaired first."""
    repair_interrupted_resaves(directory)
    p = os.path.join(directory, LATEST)
    if os.path.exists(p):
        try:
            with open(p) as f:
                s = int(f.read().strip())
            if is_complete(step_dir(directory, s)):
                return s
        except (OSError, ValueError):
            pass  # unreadable or garbled pointer: fall back to the scan
    steps = list_steps(directory, complete_only=True)
    return steps[-1] if steps else None


def write_latest(directory: str, step: int) -> None:
    tmp = os.path.join(directory, ".LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, LATEST))

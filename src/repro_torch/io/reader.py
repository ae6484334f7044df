"""Checkpoint restore (port of ``repro/io/reader.py``).

``restore_checkpoint`` dispatches on ``manifest.json["format_version"]``: v1
dirs go through the legacy npz reader, v2 dirs are assembled shard-wise.
Each leaf's region is its whole shape, or on a mesh (``shardings=``,
``mesh=``: the plan of the target and its mesh) this rank's box of it under
the plan. A region is stitched from whatever shard layout is on disk (one
process's or several, any mesh's) into one host buffer from
``_alloc_region``, copying only the overlaps out of memory-mapped shard
files, each shard's hash checked once; a plan whose layout differs from the
saved one is an elastic restore, through the same code. Leaves then move to
the device one at a time, so a restore never holds two copies of the
state:

* a target leaf that is an allocated tensor is filled in place (the train
  CLI restores into a state allocated as a fresh run allocates it: the
  model's own parameters, the optimizer state, its host step counts);
* a ``meta`` tensor becomes a new tensor on ``device``;
* a numpy or plain-scalar leaf (the port's step and SR key) becomes a host
  tensor.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.io import format as fmt
from repro_torch.io.legacy import read_npz
from repro_torch.io.tree import flatten_with_keys, plan_of, structure_repr, unflatten
from repro_torch.sharding.rules import mesh_axis_sizes
from repro_torch.sharding.specs import box_index, local_box, mesh_coords

__all__ = ["restore_checkpoint"]


Box = Tuple[Tuple[int, int], ...]


def _alloc_region(key: str, shape: Tuple[int, ...], dtype: np.dtype) -> np.ndarray:
    """Host buffer for one region of one leaf. Every host-side restore
    allocation goes through here (the spy tests patch it)."""
    return np.empty(shape, dtype)


def _open_shard(d: str, key: str, rec: Dict, dtype: np.dtype, hash_cache):
    """Memory-mapped view of one on-disk shard (validated once per shard)."""
    path = os.path.join(d, rec["file"])
    shard_shape = tuple(int(e) - int(s) for s, e in rec["index"])
    n = int(rec["nbytes"])
    expected = int(np.prod(shard_shape, dtype=np.int64)) * dtype.itemsize
    if n != expected:
        raise IOError(f"checkpoint corruption at {key}: shard in {rec['file']} records "
                      f"{n} bytes for shape {shard_shape} ({expected} expected)")
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise IOError(f"checkpoint missing shard file {rec['file']}") from e
    if size < rec["offset"] + n:
        raise IOError(f"checkpoint corruption at {key}: {rec['file']} truncated "
                      f"({size} bytes, shard ends at {rec['offset'] + n})")
    if n == 0 or shard_shape == ():
        with open(path, "rb") as f:
            f.seek(rec["offset"])
            buf = f.read(n)
        if hash_cache is not None and fmt.sha_bytes(buf) != rec["sha256"]:
            raise IOError(f"checkpoint corruption at {key} (hash mismatch)")
        return np.frombuffer(buf, dtype=dtype).reshape(shard_shape)
    mm = np.memmap(path, dtype=dtype, mode="r", offset=rec["offset"], shape=shard_shape)
    if hash_cache is not None:
        ck = (rec["file"], rec["offset"])
        if ck not in hash_cache:
            hash_cache[ck] = fmt.sha_bytes(mm.reshape(-1).view(np.uint8))
        if hash_cache[ck] != rec["sha256"]:
            raise IOError(f"checkpoint corruption at {key} (hash mismatch)")
    return mm


def _assemble_region(d: str, key: str, dtype: np.dtype, shards: List[Dict], want: Box,
                     hash_cache) -> np.ndarray:
    """The ``want`` box of one leaf, stitched from its on-disk shards."""
    region = _alloc_region(key, tuple(e - s for s, e in want), dtype)
    filled = 0
    for rec in shards:
        have = [(int(s), int(e)) for s, e in rec["index"]]
        inter = [(max(ws, rs), min(we, re_)) for (ws, we), (rs, re_) in zip(want, have)]
        if any(s >= e for s, e in inter):
            continue  # the shard does not overlap the region
        src = _open_shard(d, key, rec, dtype, hash_cache)
        src_sl = tuple(slice(s - rs, e - rs) for (s, e), (rs, _) in zip(inter, have))
        dst_sl = tuple(slice(s - ws, e - ws) for (s, e), (ws, _) in zip(inter, want))
        region[dst_sl] = src[src_sl]
        filled += int(np.prod([e - s for s, e in inter], dtype=np.int64))
    if filled < region.size:
        raise IOError(f"checkpoint incomplete at {key}: on-disk shards cover only "
                      f"{filled}/{region.size} elements of the region (missing host shard "
                      "file?)")
    return region


def _read_sharded(d: str, manifest: Dict, keys: List[str], boxes: List[Box], validate: bool):
    """Host arrays (storage dtype) of ``keys``' ``boxes``, one at a time."""
    shard_map = fmt.merged_shard_index(d)
    meta = {m["key"]: m for m in manifest["leaves"]}
    hash_cache: Optional[Dict] = {} if validate else None
    for key, box in zip(keys, boxes):
        yield _assemble_region(d, key, fmt.dtype_from_str(meta[key]["dtype"]),
                               shard_map.get(key, []), box, hash_cache)


def _check(key: str, tleaf, m: Dict, box: Box) -> None:
    t_shape = getattr(tleaf, "shape", None)  # plain-scalar leaves have none
    if t_shape is None:
        return
    shape = tuple(e - s for s, e in box)
    if tuple(t_shape) != shape:
        whole = tuple(int(x) for x in m["shape"])
        part = "" if shape == whole else f" (this rank's part {shape})"
        raise ValueError(f"checkpoint leaf {key} has shape {whole}{part}, target expects "
                         f"{tuple(t_shape)}")
    if fmt.dtype_name(tleaf) != m["dtype"]:
        raise ValueError(f"checkpoint leaf {key} has dtype {m['dtype']}, target expects "
                         f"{fmt.dtype_name(tleaf)}")


@torch.no_grad()
def _place(host: np.ndarray, dtype: str, tleaf, device) -> torch.Tensor:
    t = torch.from_numpy(host).view(fmt.torch_dtype(dtype))
    if isinstance(tleaf, torch.Tensor):
        return t.to(resolve_device(device)) if tleaf.is_meta else tleaf.copy_(t)
    return t  # numpy or scalar target (the step, the key): stays on the host


def restore_checkpoint(directory: str, target: Any, step: Optional[int] = None,
                       device="cuda", validate: bool = True, shardings: Any = None,
                       mesh=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target`` (a port state whose leaves
    may be ``meta`` tensors) -> (state, the save's ``extra``). New tensors
    land on ``device`` (``cuda`` unless the caller asks for the CPU). On a
    mesh, ``target`` holds this rank's parts and ``shardings`` is its plan
    (a ``P`` at every tensor, as ``train_loop.train_state_shardings``
    gives) over ``mesh``: each leaf's box under the plan is read, whatever
    the layout and process count that saved it."""
    if step is None:
        step = fmt.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = fmt.step_dir(directory, step)
    manifest = fmt.read_manifest(d)

    if validate and "structure" in manifest:
        got = structure_repr(target)
        if got != manifest["structure"]:
            raise ValueError(
                "checkpoint structure mismatch: the restore target's tree does not "
                "match what was saved.\n"
                f"  saved:  {manifest['structure'][:512]}\n"
                f"  target: {got[:512]}\n"
                "If the checkpoint predates the transform-chain state layout "
                "(dict {'m','v','step'}), restore into the legacy structure and "
                "convert with migrate_legacy_state(state, tx)."
            )

    flat = flatten_with_keys(target)
    keys = [k for k, _ in flat]
    meta = {m["key"]: m for m in manifest["leaves"]}
    parts = plan_of(target, shardings) if shardings is not None else {}
    if parts:
        sizes = mesh_axis_sizes(mesh)
        coord = mesh_coords(sizes)[fmt.process_index()]
    boxes = []
    for key, tleaf in flat:
        if key not in meta:
            raise KeyError(f"checkpoint missing leaf {key}")
        shape = tuple(int(x) for x in meta[key]["shape"])
        spec = parts.get(id(tleaf))
        box = (tuple((0, n) for n in shape) if spec is None
               else local_box(spec, shape, coord, sizes))
        _check(key, tleaf, meta[key], box)
        boxes.append(box)
    if manifest.get("format_version", 1) < 2:
        hosts = (np.asarray(a[box_index(b)], order="C")
                 for a, b in zip(read_npz(d, manifest, keys, validate), boxes))
    else:
        hosts = _read_sharded(d, manifest, keys, boxes, validate)
    out = []
    for (key, tleaf), host in zip(flat, hosts):
        out.append(_place(host, meta[key]["dtype"], tleaf, device))
        del host
    return unflatten(target, out), manifest["extra"]

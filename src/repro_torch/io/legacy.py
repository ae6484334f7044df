"""Legacy (format v1) single-file npz checkpoints (port of
``repro/io/legacy.py``).

The seed format: every leaf in one ``arrays.npz`` beside a v1 manifest (no
``format_version``, no COMMIT; the tmp-dir rename was the atomicity unit).
Readable behind the manifest's version switch and, for migration tooling,
writable; new saves go through ``writer`` (v2).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.io import format as fmt
from repro_torch.io.tree import flatten_with_keys, structure_repr

__all__ = ["save_checkpoint_npz", "read_npz"]


def _sha(a: np.ndarray) -> str:
    # the one checkpoint hash (v1 and v2 share it)
    return fmt.sha_bytes(np.ascontiguousarray(a).tobytes())


def save_checkpoint_npz(directory: str, step: int, tree: Any,
                        extra: Optional[Dict] = None) -> str:
    """v1 save: every leaf to the host, one npz in a tmp dir, fsync, rename,
    update LATEST."""
    from repro_torch.io.writer import _device_to_host

    os.makedirs(directory, exist_ok=True)
    final = fmt.step_dir(directory, step)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        leaves = [(key, fmt.dtype_name(leaf), _device_to_host(key, leaf))
                  for key, leaf in flatten_with_keys(tree)]
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": arr for i, (_, _, arr) in enumerate(leaves)})
        manifest = {
            "step": step,
            "extra": extra or {},
            "structure": structure_repr(tree),
            "leaves": [
                {"key": key, "name": f"a{i}", "shape": list(arr.shape), "dtype": dtype,
                 "sha256": _sha(arr)}
                for i, (key, dtype, arr) in enumerate(leaves)
            ],
        }
        with open(os.path.join(tmp, fmt.MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    fmt.write_latest(directory, step)
    return final


def read_npz(d: str, manifest: Dict, keys: List[str], validate: bool) -> List[np.ndarray]:
    """Host arrays of ``keys`` (in order) from a v1 dir, in their storage
    dtype."""
    by_key = {m["key"]: m for m in manifest["leaves"]}
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as npz:
        for key in keys:
            if key not in by_key:
                raise KeyError(f"checkpoint missing leaf {key}")
            m = by_key[key]
            arr = npz[m["name"]]
            if validate and _sha(arr) != m["sha256"]:
                raise IOError(f"checkpoint corruption at {key} (hash mismatch)")
            out.append(arr.view(fmt.dtype_from_str(m["dtype"])))
    return out

"""Build the port's CUDA kernels with ``nvcc`` at first use and load them,
and the checks and host tables their ``ctypes`` wrappers share.

Each source under ``repro_torch/csrc`` compiles on its own into a shared
library with a plain C interface, loaded with ``ctypes``. The library's name
carries a hash of the source, of every header it includes with quotes
(``common.cuh``) and of the flags, so an edited source or header never loads
a stale build; it is written under a temporary name and renamed, so
concurrent builds never load a half-written file. ``build_libraries`` starts
one ``nvcc`` per missing library, all together, and waits for them all.
Nothing here runs at import: the CPU has no ``nvcc``, and the CPU path never
builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_libraries", "load_library",
           "check_operand", "host_table"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# <repo>/build/kernels — listed in .gitignore
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# No fast math and no contracted multiply-adds: the kernels are held bit for
# bit against their plain torch versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[Path, ctypes.CDLL] = {}  # by source path


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")


_QUOTED_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def _included_files(source: Path) -> List[Path]:
    """``source`` and every file it includes with quotes, recursively (paths
    relative to the including file, as nvcc resolves them)."""
    files: List[Path] = []
    todo = [source]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / name for name in _QUOTED_INCLUDE.findall(path.read_text())]
    return files


def _library_path(source: Path) -> Path:
    """Where the library of ``source`` lives: named by the hash of the
    source, the headers it includes and the flags."""
    digest = hashlib.sha256()
    for path in _included_files(source):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build_libraries(*sources: Path) -> List[Path]:
    """Compile every source that has no library yet, one ``nvcc`` each, all
    started together; the ptxas ``-v`` report goes to a ``.log`` beside the
    library. Returns the libraries' paths in the order of ``sources``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = [_library_path(s) for s in sources]
    jobs = []
    for src, lib in zip(sources, libs):
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc {src.name} failed ({proc.returncode}):\n{out[-4000:]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load_library(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if need be (once per
    process and source)."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build_libraries(source)[0]))
    return _loaded[source]


def check_operand(kernel: str, what: str, x: torch.Tensor, dtype, shape, dev) -> None:
    """Raise unless ``x`` is what a kernel takes: on ``dev``, of ``dtype`` and
    ``shape``, contiguous and 16-byte aligned."""
    if x.device != dev:
        raise ValueError(f"{kernel}: {what} on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{kernel}: {what} dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {what} shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{kernel}: {what} must be contiguous and 16-byte aligned")


def host_table(t: torch.Tensor):
    """A sorted 2..16-point table as host fp32 arrays (table, midpoints,
    points) for a kernel's parameters; the midpoints round as
    ``mappings.encode``'s. A CPU table costs nothing; a CUDA one is copied
    down (a sync)."""
    a = t.detach().to("cpu", torch.float32).numpy().astype(np.float32)
    if not 2 <= a.size <= 16:
        raise ValueError(f"table of {a.size} points (the kernels take 2..16)")
    if np.any(a[1:] < a[:-1]):
        raise ValueError("table is not sorted (the kernels' encodes search it)")
    mid = ((a[1:] + a[:-1]) / np.float32(2.0)).astype(np.float32)
    return np.ascontiguousarray(a), np.ascontiguousarray(mid), int(a.size)

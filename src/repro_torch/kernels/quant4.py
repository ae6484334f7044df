"""Block-wise 4-bit quantize / dequantize: the CUDA kernels' wrappers and
their plain versions.

Port of ``repro/kernels/quant4.py``. The kernels (``repro_torch/csrc/
quant4.cu``) are built with ``nvcc`` for ``sm_90a`` on first use and loaded
with ``ctypes`` (``kernels.build``), like the fused AdamW kernel; the source
says what bounds them (device-memory bytes) and how they are laid out.

``quantize_blockwise_4bit`` takes an ``(R, C)`` fp32 or bf16 tensor with
``C % 128 == 0`` (no TPU tile constraint: the kernel walks the flat array in
blocks of 128) and returns ``(R, C/2)`` uint8 codes, low nibble first, and
``(R, C/128)`` fp32 guarded absmax scales; ``dequantize_blockwise_4bit`` is
its inverse, ``table[code] * scale`` as ``(R, C)`` fp32. A CUDA tensor
launches the kernel and adds one to ``LAUNCHES[<name>]``; a CPU tensor takes
the plain version (the ``ref.py`` oracles); anything else raises. There is
no fallback from the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build, ref

__all__ = [
    "quantize_blockwise_4bit",
    "dequantize_blockwise_4bit",
    "quantize_blockwise_4bit_plain",
    "dequantize_blockwise_4bit_plain",
    "bind",
    "quantize_into",
    "LAUNCHES",
    "MAX_BLOCKS",
    "SOURCE",
]

_BLOCK = 128
# blocks a launch takes (csrc/quant4.cu's kMaxBlocks: 32-bit block, pair and
# grid counts; about 2.7e11 elements)
MAX_BLOCKS = (1 << 31) - 1
SOURCE = build.CSRC / "quant4.cu"

# Kernel launches by wrapper name; only a real CUDA launch counts.
LAUNCHES: Dict[str, int] = {"quantize_blockwise_4bit": 0, "dequantize_blockwise_4bit": 0}

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a loaded build of ``quant4.cu`` (this
    tree's, or another version's when two are timed against each other)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.quantize_blockwise_4bit_launch.argtypes = [p, i, p, p, ll, p, p, i, p]
    lib.dequantize_blockwise_4bit_launch.argtypes = [p, p, p, ll, p, p, i, p]
    lib.quantize_blockwise_4bit_launch.restype = ctypes.c_int
    lib.dequantize_blockwise_4bit_launch.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = bind(build.load_library(SOURCE))
    return _lib


def quantize_blockwise_4bit_plain(x: torch.Tensor, table: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return ref.quant_blockwise(x, table.to(x.device))


def dequantize_blockwise_4bit_plain(packed: torch.Tensor, scale: torch.Tensor,
                                    table: torch.Tensor) -> torch.Tensor:
    return ref.dequant_blockwise(packed, scale, table.to(packed.device))


def _ptr(t) -> ctypes.c_void_p:
    """A device tensor's or a host numpy array's address."""
    if isinstance(t, torch.Tensor):
        return ctypes.c_void_p(t.data_ptr())
    return t.ctypes.data_as(ctypes.c_void_p)


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check_count(name: str, n: int) -> None:
    """Refuse, before a launch, an element count whose blocks do not fit
    the kernels' 32-bit counts."""
    if n // _BLOCK > MAX_BLOCKS:
        raise ValueError(f"{name}: {n} elements are {n // _BLOCK} blocks of {_BLOCK}; a launch "
                         f"takes at most {MAX_BLOCKS}")


def quantize_into(lib: ctypes.CDLL, x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                  table) -> int:
    """Launch ``lib``'s quantize kernel on checked CUDA operands and a
    ``build.host_table``; returns its cudaError_t (0: launched). Counts no
    launch: the wrapper does."""
    value, mid, points = table
    return lib.quantize_blockwise_4bit_launch(
        _ptr(x), int(x.dtype == torch.bfloat16), _ptr(codes), _ptr(scale), x.numel(),
        _ptr(value), _ptr(mid), points, _stream(x.device))


def quantize_blockwise_4bit(x: torch.Tensor, table: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, C) fp32/bf16 -> ((R, C/2) uint8 codes, (R, C/128) fp32 scales),
    round to nearest through the 2..16-point ``table`` (any device)."""
    name = "quantize_blockwise_4bit"
    if x.ndim != 2 or x.shape[1] % _BLOCK:
        raise ValueError(f"{name}: shape {tuple(x.shape)}; the kernel takes (R, C) "
                         f"with C % {_BLOCK} == 0")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {x.dtype} (fp32 or bf16 only)")
    dev = x.device
    if dev.type == "cpu":
        return quantize_blockwise_4bit_plain(x, table)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    R, C = x.shape
    build.check_operand(name, "x", x, x.dtype, (R, C), dev)
    _check_count(name, R * C)
    codes = torch.empty((R, C // 2), dtype=torch.uint8, device=dev)
    scale = torch.empty((R, C // _BLOCK), dtype=torch.float32, device=dev)
    err = quantize_into(_library(), x, codes, scale, build.host_table(table))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    LAUNCHES[name] += 1
    return codes, scale


def dequantize_blockwise_4bit(packed: torch.Tensor, scale: torch.Tensor,
                              table: torch.Tensor) -> torch.Tensor:
    """(R, C/2) uint8 codes + (R, C/128) fp32 scales -> (R, C) fp32
    ``table[code] * scale``."""
    name = "dequantize_blockwise_4bit"
    if packed.ndim != 2 or (2 * packed.shape[1]) % _BLOCK:
        raise ValueError(f"{name}: codes shape {tuple(packed.shape)}; the kernel takes "
                         f"(R, C/2) with C % {_BLOCK} == 0")
    R, C = packed.shape[0], 2 * packed.shape[1]
    dev = packed.device
    if dev.type == "cpu":
        return dequantize_blockwise_4bit_plain(packed, scale, table)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    build.check_operand(name, "codes", packed, torch.uint8, (R, C // 2), dev)
    build.check_operand(name, "scales", scale, torch.float32, (R, C // _BLOCK), dev)
    _check_count(name, R * C)
    out = torch.empty((R, C), dtype=torch.float32, device=dev)
    value, mid, points = build.host_table(table)
    err = _library().dequantize_blockwise_4bit_launch(
        _ptr(packed), _ptr(scale), _ptr(out), R * C, _ptr(value), _ptr(mid), points,
        _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    LAUNCHES[name] += 1
    return out

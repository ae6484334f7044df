"""Meshes of processes (port of ``repro/launch/mesh.py``).

``make_mesh(shape, axes, device_type)`` lays the ranks of the current
``torch.distributed`` world out row-major over named axes
(``init_device_mesh``); it needs a world of exactly that many ranks.
``device_type`` is where the collectives run: ``"cpu"`` for gloo (the CPU,
and ranks that share one card), ``"cuda"`` for NCCL with one card per rank.
``make_production_mesh`` is the reference's production layout: one pod of
256 chips as (data=16, model=16), or two pods as (pod=2, data=16,
model=16).
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["make_production_mesh", "make_mesh"]


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cpu"):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else "no"
        raise RuntimeError(f"make_mesh{shape}: needs a torch.distributed world of {n} ranks "
                           f"({have} initialised)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(data=16, model=16), or (pod=2, data=16, model=16) with ``multi_pod``;
    the pod axis carries pure data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)

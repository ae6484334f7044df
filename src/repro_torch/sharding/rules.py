"""Logical-axis -> mesh-axis sharding rules with divisibility fallbacks
(port of ``repro/sharding/rules.py``).

Every parameter carries a tuple of logical dim names (``models.param_axes``).
The rules walk an ordered candidate list and give each mesh axis to at most
one tensor dim, skipping dims it does not divide (mixtral's 8 experts on a
16-way model axis fall through to the mlp dim; hymba's 25 heads to the
row-parallel embed dim). ZeRO: optimizer-state leaves also shard their
largest still-unsharded dim over the data axes (pod x data on the
multi-pod mesh).

These are pure functions of a shape, the axes and the mesh's axis sizes. A
``mesh`` is a mapping ``{axis name: size}``, a ``torch`` ``DeviceMesh`` or
anything with ``axis_names`` and ``devices.shape``. A partition is a ``P``:
one entry per dim, each ``None``, a mesh axis name or a tuple of names.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

__all__ = [
    "P",
    "TP_RULES",
    "NEVER_SHARD",
    "mesh_axis_sizes",
    "dp_axes",
    "dp_size",
    "spec_for",
    "with_zero",
    "wire_spec",
]


class P(tuple):
    """A partition spec: ``P(None, "data", ("pod", "data"))``; ``P()`` is
    replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


# Ordered tensor-parallel candidates: (logical axis, mesh axis).
TP_RULES: Tuple[Tuple[str, str], ...] = (
    ("experts", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("vocab", "model"),
    ("state", "model"),
    ("embed", "model"),  # last resort: row-parallel (contracting-dim shard)
)

# Logical axes that are never sharded (scan/layer dims, tiny dims).
NEVER_SHARD = ("layers", "head_dim", "gates")


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    if hasattr(mesh, "mesh_dim_names"):  # torch DeviceMesh
        return dict(zip(mesh.mesh_dim_names, (int(d) for d in mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, (int(d) for d in mesh.devices.shape)))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel mesh axes, outermost first (('pod', 'data') multi-pod)."""
    sizes = mesh_axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def dp_size(mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in dp_axes(mesh):
        n *= sizes[a]
    return n


def spec_for(shape: Tuple[int, ...], axes: Tuple[str, ...], mesh,
             rules: Sequence[Tuple[str, str]] = TP_RULES) -> P:
    """Tensor-parallel partition of a parameter."""
    assert len(shape) == len(axes), (shape, axes)
    sizes = mesh_axis_sizes(mesh)
    assignment: Dict[int, str] = {}
    used = set()
    for logical, mesh_axis in rules:
        if mesh_axis in used or mesh_axis not in sizes:
            continue
        for dim, name in enumerate(axes):
            if name != logical or dim in assignment or name in NEVER_SHARD:
                continue
            if shape[dim] % sizes[mesh_axis] == 0:
                assignment[dim] = mesh_axis
                used.add(mesh_axis)
                break
    return P(*(assignment.get(d) for d in range(len(shape))))


def with_zero(shape: Tuple[int, ...], spec: P, mesh, axes: Optional[Tuple[str, ...]] = None) -> P:
    """Add the data axes over the largest still-unsharded divisible dim
    (ZeRO state sharding); with ``axes``, dims named in ``NEVER_SHARD`` are
    skipped."""
    dps = dp_axes(mesh)
    if not dps:
        return spec
    n_dp = dp_size(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if axes is not None and d < len(axes) and axes[d] in NEVER_SHARD:
            continue
        if entries[d] is None and shape[d] % n_dp == 0 and shape[d] > 0:
            entries[d] = dps if len(dps) > 1 else dps[0]
            return P(*entries)
    return P(*entries)


def wire_spec(shape: Tuple[int, ...], axes: Tuple[str, ...], mesh) -> P:
    """ZeRO wire layout of a gradient-shaped tensor (and of packed int4
    codes, which keep the parameter's ndim): ``with_zero(spec_for(...))``."""
    return with_zero(shape, spec_for(shape, axes, mesh), mesh, axes=axes)

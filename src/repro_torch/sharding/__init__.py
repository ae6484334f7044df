"""Sharding of the port (port of ``repro.sharding``): the rules engine
(``rules``), the plans over the port's trees (``specs``) and the mesh
context (``context``). The package imports only the rules, so the optimizer
core can import ``context`` without importing the plans' containers."""

from repro_torch.sharding.rules import (
    NEVER_SHARD,
    TP_RULES,
    P,
    dp_axes,
    dp_size,
    mesh_axis_sizes,
    spec_for,
    wire_spec,
    with_zero,
)

__all__ = ["P", "TP_RULES", "NEVER_SHARD", "mesh_axis_sizes", "dp_axes", "dp_size", "spec_for",
           "with_zero", "wire_spec"]

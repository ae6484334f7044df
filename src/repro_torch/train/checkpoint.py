"""Checkpointing facade (port of ``repro/train/checkpoint.py``): the I/O
lives in ``repro_torch.io`` (format v2, async double-buffered writes,
legacy npz behind the manifest's version switch); this module keeps the
reference's import surface plus the optimizer-state migration helper.

Checkpoints store the compressed optimizer state (packed 4-bit codes and
scales) as it is, so a 4-bit AdamW checkpoint is ~7x smaller than one of
fp32 states.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.optimizers.base import FactoredMoment, tree_order
from repro_torch.core.optimizers.transform import ChainState
from repro_torch.core.quantizer import QuantizedTensor
from repro_torch.io import (  # noqa: F401  (re-exported public API)
    AsyncCheckpointWriter,
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    tree_structure_repr,
)
from repro_torch.io.tree import structure_repr

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "CheckpointManager",
    "AsyncCheckpointWriter",
    "tree_structure_repr",
    "migrate_legacy_state",
]


def _device(leaf) -> torch.device:
    if isinstance(leaf, QuantizedTensor):
        return leaf.codes.device
    if isinstance(leaf, FactoredMoment):
        return leaf.row.device
    return leaf.device


def migrate_legacy_state(dict_state: Dict, tx, field_map: Optional[Dict[str, str]] = None):
    """Convert a pre-chain dict optimizer state into the ``ChainState`` layout.

    ``dict_state`` is the legacy layout (``{"m": {path: leaf}, "v": {path:
    leaf}, "step": int}`` for the AdamW family; SGDM's momentum lived under
    ``"m"``), with moment leaves fp32 tensors, ``QuantizedTensor`` or
    ``FactoredMoment``. ``tx``
    is the chain (or ``Optimizer``) the state should feed; it must use the
    legacy run's quantization policies, which is checked per moment tree.

    Returns ``tx.init``'s state with every moment tree replaced by the legacy
    one and every step count set to the legacy ``"step"``. ``field_map``
    renames legacy keys to state fields; SGDM's ``"m"`` -> ``"trace"`` is
    applied without it.
    """
    moments = {k: v for k, v in dict_state.items() if k != "step"}
    if not moments:
        raise ValueError("legacy state has no moment trees to migrate")
    step_val = dict_state.get("step")

    # a param-shaped tree of zeros from any moment tree: every leaf kind knows
    # its logical shape, which is all init needs to re-derive the layout
    template = next(iter(moments.values()))
    params_like = tree_order({
        k: torch.zeros(tuple(s.shape), dtype=torch.float32, device=_device(s))
        for k, s in template.items()
    })
    new_state = tx.init(params_like)
    if not isinstance(new_state, ChainState):
        raise TypeError(
            f"migrate_legacy_state targets ChainState layouts, got {type(new_state).__name__}"
        )

    field_map = dict(field_map or {})
    chain_fields = _namedtuple_fields(new_state)
    for k in list(moments):
        tgt = field_map.get(k, k)
        if tgt not in chain_fields and k == "m" and "trace" in chain_fields:
            tgt = "trace"  # SGDM momentum was renamed by the chain refactor
        field_map[k] = tgt
    unknown = [k for k, tgt in field_map.items() if k in moments and tgt not in chain_fields]
    if unknown:
        raise ValueError(
            f"legacy field(s) {sorted(unknown)} have no matching state field in "
            f"the target chain (available: {sorted(chain_fields)})"
        )
    by_field = {field_map[k]: v for k, v in moments.items()}

    def graft(node):
        if isinstance(node, ChainState):
            return ChainState(graft(s) for s in node.states)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            repl = {}
            for f in node._fields:
                v = getattr(node, f)
                if f in by_field:
                    want, got = structure_repr(v), structure_repr(by_field[f])
                    if want != got:
                        raise ValueError(
                            f"legacy moment {f!r} does not match the target "
                            "chain's state structure — was the chain built "
                            "with the same quantization policies?\n"
                            f"  target: {want[:300]}\n"
                            f"  legacy: {got[:300]}"
                        )
                    repl[f] = by_field[f]
                elif f == "count" and step_val is not None:
                    repl[f] = torch.tensor(int(step_val), dtype=torch.int32)
                else:
                    repl[f] = graft(v)
            return node._replace(**repl)
        return node

    return graft(new_state)


def _namedtuple_fields(node, acc=None) -> set:
    """All NamedTuple field names reachable in a state tree (not leaves)."""
    acc = set() if acc is None else acc
    if isinstance(node, ChainState):
        for s in node.states:
            _namedtuple_fields(s, acc)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        acc.update(node._fields)
        for v in node:
            _namedtuple_fields(v, acc)
    elif isinstance(node, (tuple, list)):
        for v in node:
            _namedtuple_fields(v, acc)
    return acc

"""The port's training state seen as the reference's pytree.

The reference checkpoints JAX pytrees: a leaf's key is
``jax.tree_util.keystr`` of its path, leaves come in ``tree_flatten`` order,
and the manifest records ``str(jax.tree_util.tree_structure(tree))``, which
both readers compare with the restore target's. The port holds the same
leaves in other containers, so this module is its counterpart of what the
reference takes from ``jax.tree_util``:

* ``{path: leaf}`` dicts with '/'-joined paths (``decoder/0/sub0/mlp/w1``)
  are the reference's nested dicts and lists: a segment of digits is a list
  index, dict keys come sorted;
* inside a ``PartitionState`` label, the reference keeps every parameter
  path in each moment tree, with a ``MaskedNode`` at the other labels'
  leaves (``transform.partition``); the port's label states hold only their
  own leaves, so the masked nodes are put back from ``param_paths``;
* ``TrainState.step`` (a Python int) is the reference's ``[] int32`` leaf
  and ``TrainState.key`` (a host ``(k0, k1)`` pair) its ``[2] uint32`` key;
  ``key=None`` is ``None``, as there.

``flatten_with_keys`` gives ``[(key, leaf)]`` in the reference's order (the
step and the key as numpy arrays), ``structure_repr`` the reference's
structure string, ``unflatten`` a port state rebuilt from a target and new
leaves, ``plan_of`` the partition of each tensor under a mesh plan. Node types, keys and aux data are rendered as JAX 0.9 renders them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.optimizers.base import FactoredMoment
from repro_torch.core.optimizers.transform import ChainState, PartitionState
from repro_torch.core.quantizer import QuantizedTensor
from repro_torch.sharding.specs import plan_leaves
from repro_torch.train.train_loop import TrainState

__all__ = ["flatten_with_keys", "structure_repr", "unflatten", "plan_of"]

_MASKED = "CustomNode(namedtuple[MaskedNode], [])"
_LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, int, float, bool)

Visit = Callable[[str, Any], Any]


def _tuple(parts: Sequence[str]) -> str:
    return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _walk(node: Any, key: str, fn: Visit, masked: Optional[Tuple[str, ...]]):
    """(rebuilt node, structure string). ``fn(key, leaf)`` is called for
    every leaf in the reference's order and returns the leaf to put back.
    ``masked`` holds the enclosing partition's parameter paths: a path dict
    there lists every one of them, masked where it has no entry."""
    if node is None:
        return None, "None"
    if isinstance(node, TrainState):
        params, s_p = _walk(node.params, key + ".params", fn, None)
        opt, s_o = _walk(node.opt_state, key + ".opt_state", fn, None)
        step = int(_host(fn(key + ".step", np.asarray(node.step, np.int32))))
        rng, s_k = None, "None"
        if node.key is not None:
            words = fn(key + ".key", np.asarray(node.key, np.uint32))
            rng, s_k = tuple(int(w) for w in _host(words).reshape(-1)), "*"
        return (TrainState(params, opt, step, rng),
                f"CustomNode(TrainState[()], [{s_p}, {s_o}, *, {s_k}])")
    if isinstance(node, PartitionState):
        labels = tuple(sorted(node.states))
        paths = node.param_paths
        out, parts = {}, []
        for lab in labels:
            out[lab], s = _walk(node.states[lab], f"{key}[{lab!r}]", fn, paths)
            parts.append(s)
        aux = repr((labels, paths))
        return (PartitionState(out, paths),
                f"CustomNode(PartitionState[{aux}], [{', '.join(parts)}])")
    if isinstance(node, ChainState):
        states, s = _walk(node.states, key + ".states", fn, masked)
        return ChainState(states), f"CustomNode(ChainState[None], [{s}])"
    if isinstance(node, QuantizedTensor):
        codes = fn(key + ".codes", node.codes)
        scales = tuple(fn(f"{key}.scales[{i}]", s) for i, s in enumerate(node.scales))
        aux = repr((tuple(int(d) for d in node.shape), node.config))
        return (QuantizedTensor(codes, scales, node.shape, node.config),
                f"CustomNode(QuantizedTensor[{aux}], [*, {_tuple(['*'] * len(scales))}])")
    if isinstance(node, FactoredMoment):
        row, col = fn(key + ".row", node.row), fn(key + ".col", node.col)
        return (FactoredMoment(row, col, node.shape),
                f"CustomNode(FactoredMoment[{repr((tuple(int(d) for d in node.shape),))}], "
                "[*, *])")
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # the NamedTuple states
        vals, parts = [], []
        for f in node._fields:
            v, s = _walk(getattr(node, f), f"{key}.{f}", fn, masked)
            vals.append(v)
            parts.append(s)
        return (type(node)(*vals),
                f"CustomNode(namedtuple[{type(node).__name__}], [{', '.join(parts)}])")
    if isinstance(node, Mapping):
        return _walk_dict(node, key, fn, masked)
    if isinstance(node, (list, tuple)):
        vals, parts = [], []
        for i, v in enumerate(node):
            v2, s = _walk(v, f"{key}[{i}]", fn, masked)
            vals.append(v2)
            parts.append(s)
        if isinstance(node, list):
            return vals, "[" + ", ".join(parts) + "]"
        return tuple(vals), _tuple(parts)
    if isinstance(node, _LEAF_TYPES):
        return fn(key, node), "*"
    raise TypeError(f"checkpoint tree: no pytree rule for {type(node).__name__} at {key!r}")


def _walk_dict(d: Mapping, key: str, fn: Visit, masked: Optional[Tuple[str, ...]]):
    """A ``{path: value}`` dict as the reference's nested dicts and lists."""
    if not all(isinstance(k, str) for k in d):
        raise TypeError(f"checkpoint tree: dict keys under {key!r} must be str")
    root: Dict[str, Any] = {}
    for path in (masked if masked is not None else d):
        *inner, last = path.split("/")
        level = root
        for seg in inner:
            level = level.setdefault(seg, {})
        level[last] = path
    rebuilt: Dict[str, Any] = {}

    def render(level: Dict[str, Any], prefix: str) -> str:
        names = list(level)
        if names and all(n.isdigit() for n in names):
            idx = sorted(int(n) for n in names)
            if idx != list(range(len(idx))):
                raise ValueError(f"checkpoint tree: list indices {idx} under {prefix!r}")
            return "[" + ", ".join(child(level[str(i)], f"{prefix}[{i}]") for i in idx) + "]"
        return "{" + ", ".join(f"{n!r}: {child(level[n], f'{prefix}[{n!r}]')}"
                               for n in sorted(names)) + "}"

    def child(entry, k: str) -> str:
        if isinstance(entry, dict):
            return render(entry, k)
        if entry not in d:
            return _MASKED
        rebuilt[entry], s = _walk(d[entry], k, fn, None)
        return s

    s = render(root, key)
    # render and child close over each other: clear the cells, or the cycle
    # keeps ``fn`` (and through it a restore's leaves) alive until the next
    # cyclic collection
    render = child = None
    extra = set(d) - set(rebuilt)
    if extra:
        raise ValueError(f"checkpoint tree: entries {sorted(extra)} are not parameter paths "
                         "of the enclosing partition")
    return {k: rebuilt[k] for k in d}, s


def flatten_with_keys(tree: Any) -> List[Tuple[str, Any]]:
    """``[(reference key, leaf)]`` in the reference's leaf order."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, "", lambda k, leaf: out.append((k, leaf)) or leaf, None)
    return out


def structure_repr(tree: Any) -> str:
    """The reference's ``str(jax.tree_util.tree_structure(tree))``."""
    return f"PyTreeDef({_walk(tree, '', lambda k, leaf: leaf, None)[1]})"


def unflatten(target: Any, leaves: Sequence[Any]) -> Any:
    """``target``'s port containers around ``leaves`` (in
    ``flatten_with_keys`` order; the step and the key may be 0-d / (2,)
    arrays or tensors)."""
    n = len(flatten_with_keys(target))
    if n != len(leaves):
        raise ValueError(f"unflatten: {len(leaves)} leaves for a target of {n}")
    it = iter(leaves)
    return _walk(target, "", lambda k, leaf: next(it), None)[0]


def plan_of(tree: Any, shardings: Any) -> Dict[int, Any]:
    """``id(tensor) -> its partition`` for every tensor of ``tree`` under
    ``shardings``, a plan of the same containers with a ``P`` at every
    tensor (``train_loop.train_state_shardings``). A ``TrainState``'s step
    and key are host leaves: they have no entry."""
    if isinstance(tree, TrainState):
        pairs = [*plan_leaves(tree.params, shardings.params),
                 *plan_leaves(tree.opt_state, shardings.opt_state)]
    else:
        pairs = plan_leaves(tree, shardings)
    return {id(t): spec for t, spec in pairs}

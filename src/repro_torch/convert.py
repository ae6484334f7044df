"""Parameters of the JAX package -> the port's state dict.

``params_from_jax`` takes the reference's nested parameter tree with numpy
(or array-like) leaves and returns ``{path: tensor}`` under the port's
'/'-joined paths, in the reference's leaf order; ``load_params`` copies
such a mapping into a model. ``serving_params_from_jax`` carries a serving
tree across (``prepare_params``'s output, with its quantized leaves' codes
and scales as numpy): its quantized leaves become the port's
``QuantizedTensor``s, the others tensors of their own dtype. The tests use
them so both frameworks compute with the same weights. Nothing here imports
the JAX package: a quantized leaf is anything with ``codes``, ``scales``,
``shape`` and ``config``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.quantizer import QuantConfig, QuantizedTensor

__all__ = ["params_from_jax", "serving_params_from_jax", "load_params"]


def _is_quantized(node: Any) -> bool:
    return all(hasattr(node, a) for a in ("codes", "scales", "shape", "config"))


def _flatten(node: Any, prefix: str, out: Dict[str, Any]):
    if _is_quantized(node):
        out[prefix[:-1]] = node
    elif isinstance(node, Mapping):
        for k in sorted(node):
            _flatten(node[k], f"{prefix}{k}/", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(node)


def params_from_jax(tree_of_numpy: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """Nested dict/list tree of arrays -> ``{path: fp32 tensor}`` on ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree_of_numpy, "", flat)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev) for k, v in flat.items()}


def _tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16 of its own
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def serving_params_from_jax(tree: Any, device="cuda") -> Dict[str, Any]:
    """A serving tree of the reference (nested dict/list; quantized leaves
    with numpy codes and scales) -> ``{path: QuantizedTensor or tensor}`` on
    ``device``, in the reference's leaf order."""
    dev = resolve_device(device)
    flat: Dict[str, Any] = {}
    _flatten(tree, "", flat)
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        if _is_quantized(leaf):
            fields = {f.name: getattr(leaf.config, f.name)
                      for f in dataclasses.fields(QuantConfig)}
            out[path] = QuantizedTensor(_tensor(leaf.codes, dev),
                                        tuple(_tensor(s, dev) for s in leaf.scales),
                                        tuple(leaf.shape), QuantConfig(**fields))
        else:
            out[path] = _tensor(leaf, dev)
    return out


@torch.no_grad()
def load_params(model: torch.nn.Module, params: Mapping[str, torch.Tensor]) -> None:
    """Copy ``{path: tensor}`` into the model's parameters (same set of
    paths and shapes, or it raises)."""
    from repro_torch.models import named_params

    mine = named_params(model)
    if set(mine) != set(params):
        raise KeyError(f"path mismatch: missing {sorted(set(mine) - set(params))}, "
                       f"unexpected {sorted(set(params) - set(mine))}")
    for k, p in mine.items():
        if tuple(p.shape) != tuple(params[k].shape):
            raise ValueError(f"{k}: shape {tuple(params[k].shape)}, model has {tuple(p.shape)}")
        p.copy_(params[k])

"""Parameters of the JAX package -> the port's state dict.

``params_from_jax`` takes the reference's nested parameter tree with numpy
(or array-like) leaves and returns ``{path: tensor}`` under the port's
'/'-joined paths, in the reference's leaf order; ``load_params`` copies
such a mapping into a model. The tests use them so both frameworks compute
with the same weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["params_from_jax", "load_params"]


def _flatten(node: Any, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(node, Mapping):
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

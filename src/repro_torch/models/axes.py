"""Logical axes of every parameter: the ``axes`` tree that the reference's
``init_model`` returns beside the params (``repro/models/{model,blocks,
layers,moe}.py``), as a ``{path: tuple of axis names}`` mapping over the
port's paths. The sharding rules (``repro_torch.sharding``) read it.

A stacked leaf of a scan unit carries ``"layers"`` first, then the axes of
its per-layer leaf, which depend on where the leaf sits: attention weights
under ``attn``/``self``/``cross``, the MLP under ``mlp``, the experts under
``moe``, and the block kind's own leaves; every norm (a scale, or a
LayerNorm's ``scale`` and ``bias``) is ``("embed",)``.
"""

from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.models.model import ModelConfig, init_model, named_params

__all__ = ["param_axes", "leaf_axes"]

Axes = Tuple[str, ...]

_ATTENTION: Dict[str, Axes] = {
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "q_norm": ("head_dim",),
    "k_norm": ("head_dim",),
}
_MLP: Dict[str, Axes] = {"w1": ("embed", "mlp"), "w3": ("embed", "mlp"), "w2": ("mlp", "embed")}
_MOE: Dict[str, Axes] = {
    "router": ("embed", "experts"),
    "w1": ("experts", "embed", "mlp"),
    "w3": ("experts", "embed", "mlp"),
    "w2": ("experts", "mlp", "embed"),
}
# the leaves a block kind holds directly (not under attn / mlp / moe)
_OWN: Dict[str, Dict[str, Axes]] = {
    "mlstm": {
        "w_in": ("embed", "mlp"),
        "wq": ("mlp", "heads", "head_dim"),
        "wk": ("mlp", "heads", "head_dim"),
        "wv": ("mlp", "heads", "head_dim"),
        "w_if": ("mlp", "heads"),
        "b_if": ("heads",),
        "w_out": ("mlp", "embed"),
    },
    "slstm": {
        "w_gates": ("embed", "gates", "mlp"),
        "r_gates": ("heads", "gates", "head_dim", "head_dim"),
        "w_out": ("mlp", "embed"),
    },
    "hymba": {
        "ssm_in": ("embed", "mlp"),
        "ssm_dt": ("embed", "heads"),
        "ssm_dt_bias": ("heads",),
        "ssm_B": ("embed", "heads", "state"),
        "ssm_C": ("embed", "heads", "state"),
        "ssm_A_log": ("heads",),
        "ssm_D": ("heads",),
        "ssm_out": ("mlp", "embed"),
        "scale_attn": ("embed",),
        "scale_ssm": ("embed",),
    },
}
_TOP: Dict[str, Axes] = {"embed": ("vocab", "embed"), "head": ("embed", "vocab")}


def leaf_axes(kind: str, rel: str) -> Axes:
    """Axes of one layer's leaf at ``rel`` (its path inside the block) of a
    block of ``kind``."""
    *dirs, leaf = rel.split("/")
    if dirs and dirs[0] in ("attn", "self", "cross"):
        return _ATTENTION[leaf]
    if dirs and dirs[0] == "mlp":
        return _MLP[leaf]
    if dirs and dirs[0] == "moe":
        return _MOE[leaf]
    if leaf in _OWN.get(kind, {}):
        return _OWN[kind][leaf]
    # a norm: its scale, or a LayerNorm's scale / bias
    return ("embed",)


def param_axes(cfg: ModelConfig) -> Dict[str, Axes]:
    """``{path: axes}`` for every parameter of ``cfg``'s model, in the
    reference's leaf order (shapes come from a ``meta`` model: nothing is
    allocated)."""
    from repro_torch.models.model import plan_scan_units

    kinds = {}
    for root, blocks in (("decoder", cfg.blocks), ("encoder", cfg.encoder_blocks)):
        for ui, unit in enumerate(plan_scan_units(blocks) if blocks else []):
            for si, spec in enumerate(unit.pattern):
                kinds[f"{root}/{ui}/sub{si}"] = spec.kind
    out: Dict[str, Axes] = {}
    for path, p in named_params(init_model(cfg, device="meta")).items():
        parts = path.split("/")
        if parts[0] in ("decoder", "encoder"):
            axes = ("layers",) + leaf_axes(kinds["/".join(parts[:3])], "/".join(parts[3:]))
        else:
            axes = _TOP.get(parts[0], ("embed",))
        if len(axes) != p.dim():
            raise AssertionError(f"{path}: axes {axes} for shape {tuple(p.shape)}")
        out[path] = axes
    return out

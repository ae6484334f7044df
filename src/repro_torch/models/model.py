"""Model assembly for token decoders of dense, MoE, mLSTM, sLSTM and hymba
blocks: config, scan units, init, forward, loss, and serving (cacheless
prefill, prefill with cache, decode step).

Port of ``repro/models/model.py`` (``ModelConfig``, ``plan_scan_units``,
``init_model``, ``forward_hidden``, ``loss_fn``, ``prefill``,
``init_serve_cache``, ``prefill_with_cache``, ``decode_step``). The layers
are grouped into the reference's scan units
(``plan_scan_units``: one periodic pattern, such as gemma2's local/global
pair, repeated, or maximal runs of equal layers); unit ``u`` holds one
stack of ``repeat`` layers per pattern position under the reference's paths
(``decoder/u/sub0/...``, ``decoder/u/sub1/...``), and a Python loop over
``r`` runs ``sub0[r], sub1[r], ...`` where the reference scans, summing
the MoE layers' load-balance losses in fp32 in that order (the loss adds
``0.01 *`` their sum). Tied embeddings have no ``head`` leaf: the head is
``embed.T``. The decode caches are per kind (``blocks.init_block_cache``):
K/V caches, recurrent states, or both (hymba), stacked over each stack's
layers; layer ``r`` reads and writes views of row ``r``.
``named_params`` gives the ordered ``{path: tensor}`` mapping the optimizer
takes; the serving functions take such a mapping too (for instance
``serve.weights.materialize``'s output), and update the stacked decode
caches in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from repro_torch import resolve_device
from repro_torch.models.blocks import (
    RECURRENT,
    STACKS,
    LayerSpec,
    apply_dense,
    apply_moe,
    init_block_cache,
    unstack,
)
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    INIT_STD,
    chunked_cross_entropy,
    embed_lookup,
    rmsnorm,
    softcap,
)

__all__ = ["ModelConfig", "ScanUnit", "plan_scan_units", "Transformer", "init_model",
           "forward_hidden", "loss_fn", "named_params", "init_serve_cache", "decode_step",
           "prefill", "prefill_with_cache", "cache_map", "cache_leaves"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    blocks: Tuple[LayerSpec, ...]
    num_experts: int = 0
    top_k: int = 0
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_variant: str = "rope"   # rope | rope2d (mrope | none: not ported)
    rope_theta: float = 10000.0
    sandwich_norm: bool = False
    act: str = "silu"            # silu | gelu (tanh form)
    gated_mlp: bool = True
    tie_embeddings: bool = False
    ssm_state: int = 16
    gla_chunk: int = 128
    moe_group_size: int = 2048
    ce_chunk: int = 512
    decode_k_chunk: int = 1024


@dataclasses.dataclass(frozen=True)
class ScanUnit:
    pattern: Tuple[LayerSpec, ...]
    repeat: int


def plan_scan_units(blocks: Tuple[LayerSpec, ...]) -> List[ScanUnit]:
    """Group layers into scan units (periodic pattern or maximal runs)."""
    L = len(blocks)
    for p in (1, 2, 3, 4):
        if L % p == 0 and L // p > 1:
            if all(blocks[i] == blocks[i % p] for i in range(L)):
                return [ScanUnit(tuple(blocks[:p]), L // p)]
    units: List[ScanUnit] = []
    i = 0
    while i < L:
        j = i
        while j < L and blocks[j] == blocks[i]:
            j += 1
        units.append(ScanUnit((blocks[i],), j - i))
        i = j
    return units


_NOT_PORTED = "not ported yet (ROADMAP queue A item 4(d)-(e))"


def _check_supported(cfg: ModelConfig) -> None:
    kinds = sorted({b.kind for b in cfg.blocks} - set(STACKS))
    if kinds:
        raise ValueError(f"{cfg.name}: block kinds {kinds} are {_NOT_PORTED}; the port runs "
                         f"decoder stacks of {sorted(STACKS)} blocks")
    if any(b.kind == "moe" for b in cfg.blocks) and not 0 < cfg.top_k <= cfg.num_experts:
        raise ValueError(f"{cfg.name}: moe blocks need 0 < top_k <= num_experts "
                         f"({cfg.top_k}, {cfg.num_experts})")
    if cfg.rope_variant not in ("rope", "rope2d"):
        raise ValueError(f"{cfg.name}: rope_variant {cfg.rope_variant!r} is {_NOT_PORTED}")
    if cfg.act not in ("silu", "gelu"):
        raise ValueError(f"{cfg.name}: unknown act {cfg.act!r}")
    if len(cfg.blocks) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: {len(cfg.blocks)} block specs for {cfg.num_layers} layers")


class Transformer(nn.Module):
    """Decoder LM of the block kinds of ``STACKS``; parameters are fp32 masters in the reference's
    stacked layout, one ``ModuleDict`` of ``sub{i}`` stacks per scan unit."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.units = plan_scan_units(cfg.blocks)
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty((V, D), dtype=torch.float32, device=device))
        self.decoder = nn.ModuleList([
            nn.ModuleDict({f"sub{si}": STACKS[spec.kind](cfg, unit.repeat, device)
                           for si, spec in enumerate(unit.pattern)})
            for unit in self.units])
        self.final_norm = nn.Parameter(torch.empty((D,), dtype=torch.float32, device=device))
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(torch.empty((D, V), dtype=torch.float32, device=device))

    def head_weight(self) -> torch.Tensor:
        """(D, V): ``head``, or ``embed.T`` with tied embeddings."""
        return self.embed.t() if self.cfg.tie_embeddings else self.head

    def forward(self, batch: Dict[str, torch.Tensor]):
        return loss_fn(self, batch)


def named_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    """``{path: parameter}`` with '/'-joined reference paths, in the
    reference's leaf order."""
    from repro_torch.core.optimizers.base import tree_order

    return tree_order({k.replace(".", "/"): p for k, p in model.named_parameters()})


# leaves the reference initialises to a constant, by name (the norm scales,
# ``*norm*``, ``post1``/``post2``, are ones; mLSTM's ``b_if`` is 0 for the H
# input gates and 3.0 for the H forget gates)
_CONSTANTS = {"post1": 1.0, "post2": 1.0, "ssm_dt_bias": -2.0, "ssm_A_log": 0.0, "ssm_D": 1.0,
              "scale_attn": 1.0, "scale_ssm": 1.0}


def _init_constant(path: str, p: torch.Tensor) -> bool:
    """Fill ``p`` if the reference makes its leaf a constant; True if so."""
    leaf = path.rsplit("/", 1)[-1]
    if "norm" in leaf:
        p.fill_(1.0)
    elif leaf in _CONSTANTS:
        p.fill_(_CONSTANTS[leaf])
    elif leaf == "b_if":
        H = p.shape[-1] // 2
        p[..., :H] = 0.0
        p[..., H:] = 3.0
    else:
        return False
    return True


@torch.no_grad()
def init_model(cfg: ModelConfig, seed: int = 0, device="cuda",
               generator: Optional[torch.Generator] = None) -> Transformer:
    """Random model from a seed (or an explicit generator on ``device``):
    normal(0, 0.02) weights, the reference's constants elsewhere (unit norm
    scales, mLSTM's gate bias, hymba's ``ssm_dt_bias``, ``ssm_A_log``,
    ``ssm_D`` and output scales). On the ``meta`` device only shapes are
    made. The draws are torch's, not ``jax.random``'s: to compute what the
    reference computes, load its parameters (``convert``)."""
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    model = Transformer(cfg, device=dev)
    if dev.type == "meta":
        return model
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    for path, p in named_params(model).items():
        if not _init_constant(path, p):
            p.normal_(0.0, INIT_STD, generator=generator)
    return model


# per unit, per sub: the list of that stack's per-layer parameter dicts
UnitLayers = List[List[Sequence[Dict[str, Any]]]]


def cache_map(fn, tree):
    """``fn`` applied to every tensor of a cache tree (lists, dicts,
    NamedTuples of tensors), in a tree of the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: cache_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cache_map(fn, v) for v in tree]
    return type(tree)(*(cache_map(fn, v) for v in tree))


def cache_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a cache tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    nodes = tree.values() if isinstance(tree, dict) else tree
    return [t for node in nodes for t in cache_leaves(node)]


def _write_back(view, new) -> None:
    """Copy a block's new recurrent state into its cache view, in place
    (hymba's: the SSM state of its ``{"attn", "ssm"}`` cache)."""
    if isinstance(view, dict):
        view = {k: view[k] for k in new}
    for a, b in zip(cache_leaves(view), cache_leaves(new)):
        a.copy_(b)


def _run_units(cfg: ModelConfig, units: List[ScanUnit], layers: UnitLayers, x: torch.Tensor,
               positions, caches: Optional[List[Dict[str, Any]]] = None,
               cur_pos: Optional[torch.Tensor] = None,
               kv_lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer loop shared by training and serving, in the reference's
    order: per unit, ``sub0[r], sub1[r], ...`` for each repeat ``r``.
    ``caches[u]["sub{i}"]`` is that stack's ``(repeat, ...)`` cache: layer
    ``r`` reads and writes its views (K/V in place inside attention, a
    recurrent block's new state copied back here). Returns (x, the fp32 sum
    of the MoE layers' aux losses in that order)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for ui, unit in enumerate(units):
        for r in range(unit.repeat):
            for si, spec in enumerate(unit.pattern):
                c = None if caches is None else cache_map(lambda t: t[r], caches[ui][f"sub{si}"])
                kw = dict(positions=positions, cache=c, cur_pos=cur_pos, kv_lengths=kv_lengths)
                p = layers[ui][si][r]
                if spec.kind == "moe":
                    x, a = apply_moe(p, x, spec, cfg, **kw)
                    aux = aux + a
                elif spec.kind == "dense":
                    x = apply_dense(p, x, spec, cfg, **kw)
                else:
                    x, state = RECURRENT[spec.kind](p, x, spec, cfg, **kw)
                    if c is not None:
                        _write_back(c, state)
    return x, aux


def forward_hidden(model: Transformer, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Tokens -> final hidden states (B, S, D) in bf16."""
    return _hidden_and_aux(model, batch)[0]


def _hidden_and_aux(model: Transformer, batch: Dict[str, torch.Tensor]):
    tokens = batch["tokens"]
    x = embed_lookup(model.embed, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    layers = [[list(unit[f"sub{si}"].layers()) for si in range(len(u.pattern))]
              for unit, u in zip(model.decoder, model.units)]
    x, aux = _run_units(model.cfg, model.units, layers, x, positions)
    return rmsnorm(x, model.final_norm), aux


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor]):
    """Causal LM loss (chunked CE, final-logit softcap) + 0.01 * the MoE
    load-balance aux. Returns (loss, metrics with ``ce_loss``, ``aux_loss``)."""
    x, aux = _hidden_and_aux(model, batch)
    loss = chunked_cross_entropy(x, model.head_weight(), batch["labels"],
                                 logit_cap=model.cfg.final_softcap, chunk=model.cfg.ce_chunk)
    total = loss + 0.01 * aux
    return total, {"ce_loss": loss.detach(), "aux_loss": aux.detach()}


# ---------------------------------------------------------------------------
# serving: prefill + decode over a parameter mapping
# ---------------------------------------------------------------------------


def _unit_layers(params: Mapping[str, torch.Tensor], units: List[ScanUnit]) -> UnitLayers:
    """Per-unit, per-sub lists of per-layer parameter dicts from a
    ``{path: tensor}`` mapping."""
    out: UnitLayers = []
    for ui, unit in enumerate(units):
        subs = []
        for si in range(len(unit.pattern)):
            prefix = f"decoder/{ui}/sub{si}/"
            tree: Dict[str, Any] = {}
            for path, t in params.items():
                if path.startswith(prefix):
                    *dirs, leaf = path[len(prefix):].split("/")
                    node = tree
                    for d in dirs:
                        node = node.setdefault(d, {})
                    node[leaf] = t
            subs.append(list(unstack(tree, unit.repeat)))
        out.append(subs)
    return out


def _logits(params: Mapping[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, D) final hidden -> (B, V) fp32 logits (bf16 product; the head is
    ``embed.T`` when tied), final softcap applied."""
    head = params["embed"].t() if cfg.tie_embeddings else params["head"]
    logits = torch.einsum("bd,dv->bv", x.to(COMPUTE_DTYPE),
                          head.to(COMPUTE_DTYPE)).to(torch.float32)
    if cfg.final_softcap > 0:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def init_serve_cache(cfg: ModelConfig, batch: int, s_max: int,
                     device="cuda") -> List[Dict[str, Any]]:
    """Decode cache: per scan unit, ``{"sub{i}": cache}`` stacked over the
    unit's repeats: a ``KVCache`` (``(repeat, B, slots, Hkv, D)`` bf16,
    ``pos`` ``(repeat, B, slots)``; windowed subs hold ``min(s_max,
    window)`` slots), a recurrent state, or hymba's dict of both
    (``blocks.init_block_cache``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return [{f"sub{si}": init_block_cache(cfg, spec, batch, s_max, device=dev,
                                          layers=unit.repeat)
             for si, spec in enumerate(unit.pattern)}
            for unit in plan_scan_units(cfg.blocks)]


def decode_step(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                caches: List[Dict[str, Any]], tokens: torch.Tensor, pos: torch.Tensor):
    """One serving step: tokens (B,) at absolute positions pos (B,) ->
    (next-token logits (B, V) fp32, caches updated in place)."""
    units = plan_scan_units(cfg.blocks)
    x = embed_lookup(params["embed"], tokens[:, None])  # (B, 1, D)
    x, _ = _run_units(cfg, units, _unit_layers(params, units), x, pos[:, None],
                      caches=caches, cur_pos=pos)
    x = rmsnorm(x, params["final_norm"])
    return _logits(params, cfg, x[:, 0]), caches


def prefill(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Cacheless prefill: the whole sequence forward once -> the logits at
    its last position (B, V) fp32."""
    units = plan_scan_units(cfg.blocks)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = embed_lookup(params["embed"], tokens)
    x, _ = _run_units(cfg, units, _unit_layers(params, units), x, positions)
    return _logits(params, cfg, rmsnorm(x, params["final_norm"])[:, -1])


def prefill_with_cache(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                       tokens: torch.Tensor, lengths: torch.Tensor,
                       caches: List[Dict[str, Any]]):
    """One-shot prompt consumption: right-padded tokens (B, S), real lengths
    (B,) -> (logits at each row's last real token (B, V) fp32, caches with
    the prompts' K/V and recurrent states written in place). Padded keys are
    never attended (causal), padded slots keep pos -1, and the recurrences
    take identity steps there (a = 1, k = 0; the sLSTM state frozen)."""
    units = plan_scan_units(cfg.blocks)
    B, S = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x, _ = _run_units(cfg, units, _unit_layers(params, units), x, positions,
                      caches=caches, kv_lengths=lengths)
    x = rmsnorm(x, params["final_norm"])
    last = x[torch.arange(B, device=x.device), torch.clamp_min(lengths.long() - 1, 0)]
    return _logits(params, cfg, last), caches

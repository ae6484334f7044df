"""Model assembly for dense decoder stacks: config, init, forward, loss, and
serving (prefill with cache, decode step).

Port of ``repro/models/model.py`` (``ModelConfig``, ``init_model``,
``forward_hidden``, ``loss_fn``, ``init_serve_cache``, ``prefill_with_cache``,
``decode_step``) for token decoders whose blocks are all ``dense``. The
stack is one scan unit of ``L`` stacked layers, stored under the reference's
paths (``decoder/0/sub0/...``); a Python loop over ``L`` replaces
``lax.scan``. ``named_params`` gives the ordered ``{path: tensor}`` mapping
the optimizer takes; the serving functions take such a mapping too (for
instance ``serve.weights.materialize``'s output), and update the stacked
decode cache in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.blocks import (
    DenseStack,
    LayerSpec,
    apply_dense,
    init_block_cache,
    unstack,
)
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    INIT_STD,
    chunked_cross_entropy,
    embed_lookup,
    rmsnorm,
)

__all__ = ["ModelConfig", "Transformer", "init_model", "forward_hidden", "loss_fn", "named_params",
           "init_serve_cache", "decode_step", "prefill_with_cache"]

_STACK = "decoder/0/sub0/"  # the one scan unit's parameter paths


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
    rope_theta: float = 10000.0
    gated_mlp: bool = True
    ce_chunk: int = 512
    decode_k_chunk: int = 1024


class Transformer(nn.Module):
    """Dense decoder LM; parameters are fp32 masters in the reference's
    stacked layout."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if any(b.kind != "dense" for b in cfg.blocks) or len(cfg.blocks) != cfg.num_layers:
            raise ValueError(f"{cfg.name}: the port runs dense decoder stacks only")
        if len(set(cfg.blocks)) != 1:
            raise ValueError(f"{cfg.name}: the port runs one homogeneous scan unit only")
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty((V, D), dtype=torch.float32, device=device))
        self.decoder = nn.ModuleList([nn.ModuleDict({"sub0": DenseStack(cfg, cfg.num_layers, device)})])
        self.final_norm = nn.Parameter(torch.empty((D,), dtype=torch.float32, device=device))
        self.head = nn.Parameter(torch.empty((D, V), dtype=torch.float32, device=device))

    def forward(self, batch: Dict[str, torch.Tensor]):
        return loss_fn(self, batch)


def named_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    """``{path: parameter}`` with '/'-joined reference paths, in the
    reference's leaf order."""
    from repro_torch.core.optimizers.base import tree_order

    return tree_order({k.replace(".", "/"): p for k, p in model.named_parameters()})


@torch.no_grad()
def init_model(cfg: ModelConfig, seed: int = 0, device="cuda",
               generator: Optional[torch.Generator] = None) -> Transformer:
    """Random model from a seed (or an explicit generator on ``device``):
    normal(0, 0.02) weights, unit norm scales. On the ``meta`` device only
    shapes are made. The draws are torch's, not ``jax.random``'s: to compute
    what the reference computes, load its parameters (``convert``)."""
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    model = Transformer(cfg, device=dev)
    if dev.type == "meta":
        return model
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    for path, p in named_params(model).items():
        if "norm" in path:
            p.fill_(1.0)
        else:
            p.normal_(0.0, INIT_STD, generator=generator)
    return model


def _run_stack(cfg: ModelConfig, layers: Iterable[Dict[str, Any]], x: torch.Tensor, positions,
               cache: Optional[KVCache] = None, cur_pos: Optional[torch.Tensor] = None,
               kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer loop shared by training and serving. ``cache`` is the
    stack's ``(L, ...)`` cache: layer ``l`` reads and writes its views."""
    spec = cfg.blocks[0]
    for l, p in enumerate(layers):
        c = None if cache is None else KVCache(cache.k[l], cache.v[l], cache.pos[l])
        x = apply_dense(p, x, spec, cfg, positions=positions, cache=c, cur_pos=cur_pos,
                        kv_lengths=kv_lengths)
    return x


def forward_hidden(model: Transformer, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Tokens -> final hidden states (B, S, D) in bf16."""
    tokens = batch["tokens"]
    x = embed_lookup(model.embed, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _run_stack(model.cfg, model.decoder[0]["sub0"].layers(), x, positions)
    return rmsnorm(x, model.final_norm)


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor]):
    """Causal LM loss (chunked CE). Returns (loss, metrics)."""
    x = forward_hidden(model, batch)
    loss = chunked_cross_entropy(x, model.head, batch["labels"], chunk=model.cfg.ce_chunk)
    return loss, {"ce_loss": loss.detach(), "aux_loss": torch.zeros((), device=loss.device)}


# ---------------------------------------------------------------------------
# serving: prefill + decode over a parameter mapping
# ---------------------------------------------------------------------------


def _stack_layers(params: Mapping[str, torch.Tensor], cfg: ModelConfig):
    """Per-layer parameter dicts from a ``{path: tensor}`` mapping."""
    tree: Dict[str, Any] = {}
    for path, t in params.items():
        if path.startswith(_STACK):
            *dirs, leaf = path[len(_STACK):].split("/")
            node = tree
            for d in dirs:
                node = node.setdefault(d, {})
            node[leaf] = t
    return unstack(tree, cfg.num_layers)


def _logits(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(B, D) final hidden -> (B, V) fp32 logits (bf16 product)."""
    return torch.einsum("bd,dv->bv", x.to(COMPUTE_DTYPE),
                        params["head"].to(COMPUTE_DTYPE)).to(torch.float32)


def init_serve_cache(cfg: ModelConfig, batch: int, s_max: int,
                     device="cuda") -> List[Dict[str, KVCache]]:
    """Decode cache: one unit of ``{"sub0": KVCache}``, stacked over the
    layers (``(L, B, slots, Hkv, D)`` bf16, ``pos`` ``(L, B, slots)``)."""
    dev = resolve_device(device)
    return [{"sub0": init_block_cache(cfg, cfg.blocks[0], batch, s_max, device=dev,
                                      layers=cfg.num_layers)}]


def decode_step(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                caches: List[Dict[str, KVCache]], tokens: torch.Tensor, pos: torch.Tensor):
    """One serving step: tokens (B,) at absolute positions pos (B,) ->
    (next-token logits (B, V) fp32, caches updated in place)."""
    x = embed_lookup(params["embed"], tokens[:, None])  # (B, 1, D)
    x = _run_stack(cfg, _stack_layers(params, cfg), x, pos[:, None],
                   cache=caches[0]["sub0"], cur_pos=pos)
    x = rmsnorm(x, params["final_norm"])
    return _logits(params, x[:, 0]), caches


def prefill_with_cache(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                       tokens: torch.Tensor, lengths: torch.Tensor,
                       caches: List[Dict[str, KVCache]]):
    """One-shot prompt consumption: right-padded tokens (B, S), real lengths
    (B,) -> (logits at each row's last real token (B, V) fp32, caches with
    the prompts' K/V written in place). Padded keys are never attended
    (causal), and padded slots keep pos -1."""
    B, S = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _run_stack(cfg, _stack_layers(params, cfg), x, positions,
                   cache=caches[0]["sub0"], kv_lengths=lengths)
    x = rmsnorm(x, params["final_norm"])
    last = x[torch.arange(B, device=x.device), torch.clamp_min(lengths.long() - 1, 0)]
    return _logits(params, last), caches

"""Model assembly for dense decoder stacks: config, init, forward, loss.

Port of ``repro/models/model.py`` (``ModelConfig``, ``init_model``,
``forward_hidden``, ``loss_fn``) for token decoders whose blocks are all
``dense``. The stack is one scan unit of ``L`` stacked layers, stored under
the reference's paths (``decoder/0/sub0/...``); a Python loop over ``L``
replaces ``lax.scan``. ``named_params`` gives the ordered ``{path: tensor}``
mapping the optimizer takes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch import resolve_device
from repro_torch.models.blocks import DenseStack, LayerSpec, apply_dense
from repro_torch.models.layers import INIT_STD, chunked_cross_entropy, embed_lookup, rmsnorm

__all__ = ["ModelConfig", "Transformer", "init_model", "forward_hidden", "loss_fn", "named_params"]


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


def forward_hidden(model: Transformer, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Tokens -> final hidden states (B, S, D) in bf16."""
    cfg = model.cfg
    tokens = batch["tokens"]
    x = embed_lookup(model.embed, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    stack = model.decoder[0]["sub0"]
    spec = cfg.blocks[0]
    for p in stack.layers():
        x = apply_dense(p, x, spec, cfg, positions=positions)
    return rmsnorm(x, model.final_norm)


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor]):
    """Causal LM loss (chunked CE). Returns (loss, metrics)."""
    x = forward_hidden(model, batch)
    loss = chunked_cross_entropy(x, model.head, batch["labels"], chunk=model.cfg.ce_chunk)
    return loss, {"ce_loss": loss.detach(), "aux_loss": torch.zeros((), device=loss.device)}

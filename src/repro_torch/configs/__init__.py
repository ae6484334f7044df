"""Architecture registry of the port (port of ``repro.configs`` for the
slice's one dense config) and the reduced CPU-scale config of the same
family."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.models import LayerSpec, ModelConfig

__all__ = ["ARCHS", "get_config", "reduced_config"]


def internlm2_1_8b() -> ModelConfig:
    """internlm2-1.8b [arXiv:2403.17297]: 24L d_model=2048 16H (GQA kv=8)
    d_ff=8192 vocab=92544 (``repro/configs/internlm2_1_8b.py``)."""
    return ModelConfig(
        name="internlm2-1.8b",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92544,
        blocks=(LayerSpec("dense", 0),) * 24,
    )


ARCHS: Dict[str, Callable[[], ModelConfig]] = {"internlm2-1.8b": internlm2_1_8b}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; the port has: {sorted(ARCHS)}")
    return ARCHS[name]()


def reduced_config(name: str) -> ModelConfig:
    """Small same-family config for CPU runs (the reference's
    ``reduced_config`` for dense archs): <= 4 layers, d_model 64, <= 4
    heads of 16, d_ff 256 (kernel-eligible mlp leaves), vocab 512."""
    cfg = get_config(name)
    L = min(cfg.num_layers, 4)
    blocks = tuple(LayerSpec(b.kind, min(b.window, 16) if b.window else 0) for b in cfg.blocks[:L])
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        cfg, num_layers=L, blocks=blocks, d_model=64, num_heads=heads, num_kv_heads=kv,
        head_dim=16, d_ff=256 if cfg.d_ff else 0, vocab_size=512,
    )

"""``meta``-device stand-ins for every model input (port of
``repro/launch/specs.py``): the dry run and the roofline count against
these, and nothing is allocated. The modality-stub archs get precomputed
embeddings (qwen2-vl's patches, whisper's audio frames), as in the
reference.

Enc-dec shape convention: a shape's seq_len splits evenly into encoder
frames and decoder tokens (whisper train_4k = 2048 frames + 2048 tokens).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.models import ModelConfig, init_serve_cache

__all__ = ["input_specs", "serve_cache_specs", "decode_cache_len"]

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _train_like(cfg: ModelConfig, B: int, S: int, with_labels: bool) -> Dict[str, Any]:
    batch: Dict[str, Any] = {}
    if cfg.family == "encdec":
        Se = Sd = S // 2
        batch["frames"] = _spec((B, Se, cfg.d_model), torch.bfloat16)
        batch["tokens"] = _spec((B, Sd), torch.int32)
        if with_labels:
            batch["labels"] = _spec((B, Sd), torch.int32)
        return batch
    if cfg.input_mode == "embeds":
        batch["embeds"] = _spec((B, S, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = _spec((B, S), torch.int32)
    if cfg.rope_variant == "mrope":
        batch["positions"] = _spec((3, B, S), torch.int32)
    if with_labels:
        batch["labels"] = _spec((B, S), torch.int32)
    return batch


def decode_cache_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Cache capacity for a decode shape. Enc-dec splits seq in half."""
    return shape.seq_len // 2 if cfg.family == "encdec" else shape.seq_len


def serve_cache_specs(cfg: ModelConfig, B: int, s_max: int):
    """The decode cache tree on ``meta`` (no allocation)."""
    return init_serve_cache(cfg, B, s_max, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Inputs of the step a shape runs:

    * train  -> train_step batch (tokens/embeds/frames + labels)
    * prefill-> prefill batch (no labels)
    * decode -> {tokens (B,), pos (B,), caches, [enc_out]}
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return _train_like(cfg, B, S, with_labels=True)
    if shape.kind == "prefill":
        return _train_like(cfg, B, S, with_labels=False)
    s_max = decode_cache_len(cfg, shape)
    out: Dict[str, Any] = {
        "tokens": _spec((B,), torch.int32),
        "pos": _spec((B,), torch.int32),
        "caches": serve_cache_specs(cfg, B, s_max),
    }
    if cfg.family == "encdec":
        out["enc_out"] = _spec((B, s_max, cfg.d_model), torch.bfloat16)
    return out

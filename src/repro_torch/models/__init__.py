"""Decoder models of the port (port of ``repro.models``)."""

from repro_torch.models.blocks import LayerSpec
from repro_torch.models.model import (
    ModelConfig,
    ScanUnit,
    Transformer,
    decode_step,
    forward_hidden,
    init_model,
    init_serve_cache,
    loss_fn,
    named_params,
    plan_scan_units,
    prefill,
    prefill_with_cache,
)

__all__ = [
    "LayerSpec",
    "ModelConfig",
    "ScanUnit",
    "plan_scan_units",
    "Transformer",
    "init_model",
    "forward_hidden",
    "loss_fn",
    "named_params",
    "init_serve_cache",
    "decode_step",
    "prefill",
    "prefill_with_cache",
]

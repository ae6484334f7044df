"""Models of the port (port of ``repro.models``)."""

from repro_torch.models.axes import param_axes
from repro_torch.models.blocks import LayerSpec
from repro_torch.models.model import (
    ModelConfig,
    ScanUnit,
    Transformer,
    decode_step,
    encode,
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
    "encode",
    "prefill",
    "prefill_with_cache",
    "param_axes",
]

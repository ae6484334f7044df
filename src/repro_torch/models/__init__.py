"""Dense decoder model of the port (port of ``repro.models``)."""

from repro_torch.models.blocks import LayerSpec
from repro_torch.models.model import (
    ModelConfig,
    Transformer,
    forward_hidden,
    init_model,
    loss_fn,
    named_params,
)

__all__ = [
    "LayerSpec",
    "ModelConfig",
    "Transformer",
    "init_model",
    "forward_hidden",
    "loss_fn",
    "named_params",
]

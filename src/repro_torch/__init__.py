"""PyTorch/CUDA port of ``repro`` (4-bit optimizer states), module for module.

Each module names the JAX module it is held against. The port imports torch
and numpy only; every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A missing GPU is an error, never a
    silent CPU run: callers that want the CPU ask for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but no GPU is available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev

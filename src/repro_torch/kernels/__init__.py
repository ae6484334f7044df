"""Kernels of the port: the fused 4-bit AdamW CUDA kernel and its plain
torch versions (port of ``repro.kernels``)."""

"""Kernels of the port (port of ``repro.kernels``): the fused 4-bit AdamW and
the block-wise 4-bit quantize / dequantize CUDA kernels, their plain torch
versions, and the build that compiles them."""

"""Quantization core (port of ``repro.core``)."""

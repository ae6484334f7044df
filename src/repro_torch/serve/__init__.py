"""Serving (port of ``repro.serve``): continuous-batching engine, on-device
sampling, bf16 and q4 weight formats."""

from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import request_key_words, sample_tokens
from repro_torch.serve.weights import (
    WEIGHT_MODES,
    WEIGHT_Q4,
    format_weight_table,
    materialize,
    prepare_params,
    weight_report,
)

__all__ = [
    "Request",
    "ServeEngine",
    "sample_tokens",
    "request_key_words",
    "WEIGHT_MODES",
    "WEIGHT_Q4",
    "prepare_params",
    "materialize",
    "weight_report",
    "format_weight_table",
]

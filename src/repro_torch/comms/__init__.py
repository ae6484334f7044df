"""Gradient wire formats of the train step (port of ``repro.comms``).

``CommsConfig`` is the one gradient-compression knob (``--grad-comm
{fp32,bf16,int8,int4}``); ``reduce_grads`` applies the configured wire
format to the gradient mapping inside the train step; ``accounting`` owns
bytes-on-the-wire reporting; ``quantized_all_reduce`` is the wire primitive
of a mesh and ``collectives`` the transport under it.
"""

from repro_torch.comms.accounting import (
    format_wire_table,
    leaf_wire_bytes,
    mode_totals,
    wire_report,
)
from repro_torch.comms.config import GRAD_COMM_KEY_DOMAIN, GRAD_COMM_MODES, CommsConfig
from repro_torch.comms.reduce import grad_comm_key, quantized_all_reduce, reduce_grads

__all__ = [
    "GRAD_COMM_MODES",
    "GRAD_COMM_KEY_DOMAIN",
    "CommsConfig",
    "grad_comm_key",
    "quantized_all_reduce",
    "reduce_grads",
    "leaf_wire_bytes",
    "wire_report",
    "mode_totals",
    "format_wire_table",
]

"""Bytes of every tensor of the optimizer state (codes, scales, fp32
moments, counts), each counted once, in GB (1e9 B)."""


def read(run):
    return run["opt_state_bytes"] / 1e9

"""The whole optimizer update against its byte bound: the least bytes any
implementation must move (each leaf's fp32 gradient and parameter read, the
parameter written, every moment read and written, as the state stores
them) at the card's HBM bandwidth, over the update's time a step."""

import yardstick


def read(run):
    if not run["steps"] or run["optimizer_ms"] <= 0:
        return None
    least_s = run["update_least_bytes"] / yardstick.HBM_BYTES_PER_S
    return 100.0 * least_s / (run["optimizer_ms"] / run["steps"] / 1e3)

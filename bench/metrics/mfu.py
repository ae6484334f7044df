"""The whole step's share of the card's bf16 peak: the useful FLOPs of the
window's steps (6 N_active per token plus the causal attention's products;
recompute not counted) over the window's time."""

import yardstick


def read(run):
    if not run["steps"]:
        return None
    flops = run["flops_per_step"] * run["steps"]
    return 100.0 * flops / run["window_s"] / yardstick.PEAK_BF16_FLOPS

"""Learning-rate schedules (port of ``repro/core/optimizers/schedule.py``).

A schedule maps the integer step to the fp32 learning rate, computed on the
host in numpy float32 with the reference's operation order, so the value
is the reference's to the bit and no device work is needed to read it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["constant", "linear_warmup_linear_decay", "linear_warmup_cosine", "fp32_power"]

_f = np.float32


def fp32_power(base: float, step: int) -> np.float32:
    """``jnp.power(f32(base), f32(step))``: the double power of the fp32 base,
    rounded to fp32. It is correctly rounded; XLA's CPU power is not
    always, and the two first part at step 685 for 0.9 (none below 700
    for 0.999), so bias corrections match the reference bit for bit over
    the first 684 steps of the default betas."""
    return _f(np.float64(_f(base)) ** np.float64(_f(step)))


def constant(lr: float):
    return lambda step: _f(lr)


def linear_warmup_linear_decay(lr: float, warmup: int, total: int):
    """The schedule used across the paper's fine-tuning benchmarks."""

    def f(step):
        s = _f(step)
        warm = _f(lr) * s / _f(max(1.0, float(warmup)))
        decay = _f(lr) * max(_f(0.0), (_f(total) - s) / _f(max(1.0, float(total - warmup))))
        return _f(warm if s < warmup else decay)

    return f


def linear_warmup_cosine(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    """Warmup, then cosine decay to ``final_frac * lr``; fp32 throughout, in
    the reference's operation order (``cos`` of the fp32 product ``pi * t``)."""

    def f(step):
        s = _f(step)
        warm = _f(lr) * s / _f(max(1.0, float(warmup)))
        t = min(max((s - _f(warmup)) / _f(max(1.0, float(total - warmup))), _f(0.0)), _f(1.0))
        cos = _f(final_frac) + _f((1 - final_frac) * 0.5) * (_f(1) + np.cos(_f(np.pi) * t))
        return _f(warm if s < warmup else _f(lr) * cos)

    return f

"""Device time of a kernel's wrapper call on the card, by CUDA events.

Two methods, which measure different things:

- ``event_ms``: one call between two events, median of ``reps``. The host's
  time per call (the wrapper's checks, allocations, the launch itself)
  falls between the events too, so a short kernel reads long.
- ``per_launch_ms``: ``launches`` calls back to back between two events,
  divided, median of ``reps``. The host's time per call hides behind the
  kernels' unless it is the longer.

Both need a CUDA device; each sample waits for its closing event.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["event_ms", "per_launch_ms"]


def _median(times):
    times = sorted(times)
    return times[len(times) // 2]


def _sample(fn: Callable[[], object], launches: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches


def event_ms(fn: Callable[[], object], reps: int = 21) -> float:
    """Median ms of one call of ``fn`` between two CUDA events."""
    return _median([_sample(fn, 1) for _ in range(reps)])


def per_launch_ms(fn: Callable[[], object], launches: int = 20, reps: int = 5) -> float:
    """Median ms per call of ``fn`` over ``launches`` back-to-back calls
    between two CUDA events."""
    return _median([_sample(fn, launches) for _ in range(reps)])

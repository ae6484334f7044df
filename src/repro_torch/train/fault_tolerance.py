"""Checkpoint/restart driving (port of ``checkpoint_hooks`` and
``run_with_recovery`` from ``repro/train/fault_tolerance.py``).

``run_with_recovery`` drives a train loop with simulated failures: on
failure it restores the latest complete checkpoint and continues.
``checkpoint_hooks`` wires its ``(save, restore_latest)`` callbacks onto a
``repro_torch.io.CheckpointManager``: async saves, and a restore that falls
back past incomplete (uncommitted) save dirs.
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional, Tuple

from repro_torch.io import format as ckfmt

__all__ = ["run_with_recovery", "checkpoint_hooks"]


def checkpoint_hooks(
    manager,
    get_state: Callable[[], object],
    set_state: Callable[[object], None],
    make_target: Callable[[], object],
    device="cuda",
) -> Tuple[Callable[[int], None], Callable[[], int]]:
    """(save, restore_latest) callbacks for ``run_with_recovery``.

    ``save(step)`` snapshots ``get_state()`` and returns once the
    device-to-host copy is done (serialisation and COMMIT run in the
    background). ``restore_latest()`` restores the newest complete step
    onto ``device`` (a save killed mid-shard-write is skipped), hands it to
    ``set_state`` and returns the step to resume from (0 when there is no
    complete checkpoint). ``make_target`` builds the restore target.
    """

    def save(step: int) -> None:
        manager.save(step, get_state())

    def restore_latest() -> int:
        # manager.latest_step drains in-flight saves itself, so the step it
        # reports cannot be superseded (and collected) by a pending commit
        try:
            step = manager.latest_step()
        except Exception as e:
            # a background save that failed (ENOSPC, disk fault) must not
            # abort recovery: fall back to the last complete step. The queue
            # is drained by the time wait() re-raises, so the scan cannot
            # race an in-flight commit.
            warnings.warn(f"discarding failed async checkpoint save during recovery: {e!r}")
            step = ckfmt.latest_step(manager.directory)
        if step is None:
            return 0
        state, _ = manager.restore(make_target(), step=step, device=device)
        set_state(state)
        return step

    return save, restore_latest


def run_with_recovery(
    steps: int,
    train_one: Callable[[int], float],
    save: Callable[[int], None],
    restore_latest: Callable[[], int],
    checkpoint_every: int = 10,
    failure_injector: Optional[Callable[[int], bool]] = None,
    max_restarts: int = 10,
):
    """Drive a loop with checkpoint/restart semantics. ``train_one(step)``
    returns the loss; ``failure_injector(step)`` returning True simulates a
    node failure at that step. Returns (losses, restarts, steps_replayed)."""
    losses: List[float] = []
    restarts = 0
    replayed = 0
    step = 0
    while step < steps:
        try:
            if failure_injector is not None and failure_injector(step):
                raise RuntimeError(f"injected node failure at step {step}")
            loss = train_one(step)
            losses.append(loss)
            if (step + 1) % checkpoint_every == 0:
                save(step + 1)
            step += 1
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            resumed = restore_latest()
            replayed += step - resumed
            step = resumed
    return losses, restarts, replayed

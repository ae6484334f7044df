"""Fault tolerance (port of ``repro/train/fault_tolerance.py``): straggler
detection, host liveness, elastic re-planning and checkpoint/restart
driving.

``StragglerDetector`` flags hosts slower than ``threshold`` x the median of
the per-host rolling medians for ``patience`` consecutive checks.
``HostMonitor`` is a heartbeat registry (heartbeats are injected; a missed
deadline marks a host dead). ``plan_elastic`` turns the surviving hosts into
an ``ElasticPlan``: the hosts re-derive their data slices from (step,
host_index, num_hosts), because the pipeline is stateless.
``run_with_recovery`` drives a train loop with simulated failures: on
failure it restores the latest complete checkpoint and continues.
``checkpoint_hooks`` wires its ``(save, restore_latest)`` callbacks onto a
``repro_torch.io.CheckpointManager``: async saves, and a restore that falls
back past incomplete (uncommitted) save dirs and, on a mesh, reads each
rank's part under the current plan, whatever layout saved it.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.io import format as ckfmt

__all__ = ["StragglerDetector", "HostMonitor", "ElasticPlan", "plan_elastic",
           "run_with_recovery", "checkpoint_hooks"]


class StragglerDetector:
    """Flags hosts whose step time exceeds ``threshold`` x rolling median for
    ``patience`` consecutive steps."""

    def __init__(self, threshold: float = 1.5, window: int = 16, patience: int = 3):
        self.threshold = threshold
        self.window = window
        self.patience = patience
        self._times: Dict[int, collections.deque] = {}
        self._strikes: Dict[int, int] = collections.defaultdict(int)

    def record(self, host: int, step_time: float):
        self._times.setdefault(host, collections.deque(maxlen=self.window)).append(step_time)

    def medians(self) -> Dict[int, float]:
        return {h: float(np.median(t)) for h, t in self._times.items() if t}

    def stragglers(self) -> List[int]:
        meds = self.medians()
        if len(meds) < 2:
            return []
        global_median = float(np.median(list(meds.values())))
        out = []
        for h, m in meds.items():
            self._strikes[h] = self._strikes[h] + 1 if m > self.threshold * global_median else 0
            if self._strikes[h] >= self.patience:
                out.append(h)
        return out


class HostMonitor:
    """Heartbeat registry; heartbeats are injected through ``beat``."""

    def __init__(self, hosts: Sequence[int], deadline_s: float = 60.0, clock=time.monotonic):
        self.deadline_s = deadline_s
        self.clock = clock
        self.last_beat = {h: clock() for h in hosts}

    def beat(self, host: int, at: Optional[float] = None):
        self.last_beat[host] = self.clock() if at is None else at

    def dead_hosts(self) -> List[int]:
        now = self.clock()
        return [h for h, t in self.last_beat.items() if now - t > self.deadline_s]

    def alive(self) -> List[int]:
        dead = set(self.dead_hosts())
        return [h for h in self.last_beat if h not in dead]


@dataclasses.dataclass
class ElasticPlan:
    """Resharding decision after a membership change."""

    hosts: List[int]
    restore_step: Optional[int]

    @property
    def num_hosts(self) -> int:
        return len(self.hosts)

    def host_index(self, host: int) -> int:
        return self.hosts.index(host)


def plan_elastic(alive_hosts: Sequence[int], latest_checkpoint: Optional[int],
                 min_hosts: int = 1) -> ElasticPlan:
    hosts = sorted(alive_hosts)
    if len(hosts) < min_hosts:
        raise RuntimeError(f"only {len(hosts)} hosts alive, below minimum {min_hosts}")
    return ElasticPlan(hosts=hosts, restore_step=latest_checkpoint)


def checkpoint_hooks(
    manager,
    get_state: Callable[[], object],
    set_state: Callable[[object], None],
    make_target: Callable[[], object],
    device="cuda",
    make_shardings: Optional[Callable[[], Tuple[object, object]]] = None,
) -> Tuple[Callable[[int], None], Callable[[], int]]:
    """(save, restore_latest) callbacks for ``run_with_recovery``.

    ``save(step)`` snapshots ``get_state()`` and returns once the
    device-to-host copy is done (serialisation and COMMIT run in the
    background). ``restore_latest()`` restores the newest complete step
    onto ``device`` (a save killed mid-shard-write is skipped), hands it to
    ``set_state`` and returns the step to resume from (0 when there is no
    complete checkpoint). ``make_target`` builds the restore target;
    ``make_shardings`` (optional) gives ``(plan, mesh)`` of the current
    layout, with which a mesh state is saved and restored: an elastic
    restart reads each rank's part under the new plan. With the world
    changed, ``plan_elastic`` names the step to restore.
    """

    def layout():
        return make_shardings() if make_shardings is not None else (None, None)

    def save(step: int) -> None:
        shardings, mesh = layout()
        manager.save(step, get_state(), shardings=shardings, mesh=mesh)

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
        shardings, mesh = layout()
        state, _ = manager.restore(make_target(), step=step, device=device,
                                   shardings=shardings, mesh=mesh)
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

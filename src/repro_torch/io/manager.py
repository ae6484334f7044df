"""Checkpoint lifecycle manager: async saves + retention (port of
``repro/io/manager.py``).

``CheckpointManager(dir, keep_last=N, keep_every=k)`` drives the async
writer and, after each COMMIT, deletes superseded step dirs: all but the
newest ``keep_last`` complete steps and (with ``keep_every``) the steps
divisible by ``keep_every``. The newest complete step is never deleted;
incomplete dirs older than it (crash leftovers), steps newer than the one
just committed (an abandoned timeline after a rewind) and orphaned
``.attempt_*`` stages are swept too. GC runs on the writer thread of
process 0 only, after the commit that triggered it. On a mesh, ``save`` and
``restore`` take the state's plan and mesh (``shardings=``, ``mesh=``), as
``io.writer`` and ``io.reader`` do.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

from repro_torch.io import format as fmt
from repro_torch.io.reader import restore_checkpoint
from repro_torch.io.writer import AsyncCheckpointWriter

__all__ = ["CheckpointManager"]


class CheckpointManager:
    """Async keep-last / keep-every manager over format v2."""

    def __init__(self, directory: str, keep_last: int = 3, keep_every: Optional[int] = None):
        self.directory = directory
        self.keep_last = max(1, int(keep_last))
        self.keep_every = int(keep_every) if keep_every else None
        self._writer = AsyncCheckpointWriter(directory, on_commit=self._gc)

    @property
    def commit_times(self) -> Dict[int, float]:
        """``perf_counter()`` at each committed step's COMMIT."""
        return self._writer.commit_times

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None, block: bool = False,
             shardings: Any = None, mesh=None):
        """Blocks only on the device-to-host snapshot (and when two saves
        are already in flight); serialisation and COMMIT run in the
        background."""
        self._writer.save(step, tree, extra, block=block, shardings=shardings, mesh=mesh)

    def wait(self):
        self._writer.wait()

    def latest_step(self) -> Optional[int]:
        # drain in-flight saves first: latest_step's crash repair must not
        # race the writer thread's final stage -> step_X swap
        self.wait()
        return fmt.latest_step(self.directory)

    def restore(self, target, step=None, device="cuda", shardings=None, mesh=None):
        self.wait()
        return restore_checkpoint(self.directory, target, step, device=device,
                                  shardings=shardings, mesh=mesh)

    def _gc(self, committed_step: Optional[int] = None):
        if fmt.process_index() != 0:
            return
        steps: Dict[int, bool] = {}
        attempt_dirs = []
        for name in os.listdir(self.directory):
            if ".attempt_" in name:
                attempt_dirs.append(name)
                continue
            s = fmt.parse_step(name)
            if s is not None:
                steps[s] = fmt.is_complete(os.path.join(self.directory, name))
        complete = sorted(s for s, ok in steps.items() if ok)
        if committed_step is not None:
            # steps newer than the one just committed belong to an abandoned
            # timeline (a rewind replayed past them)
            for s in complete:
                if s > committed_step:
                    shutil.rmtree(fmt.step_dir(self.directory, s), ignore_errors=True)
            complete = [s for s in complete if s <= committed_step]
        if not complete:
            return
        newest = complete[-1]
        keep = set(complete[-self.keep_last:])
        if self.keep_every:
            keep.update(s for s in complete if s % self.keep_every == 0)
        keep.add(newest)  # the newest complete step is never collected
        for s in complete:
            if s not in keep:
                shutil.rmtree(fmt.step_dir(self.directory, s), ignore_errors=True)
        # incomplete dirs older than the newest complete save can never
        # become restorable; newer ones are a save in flight
        for s, ok in steps.items():
            if s < newest and not ok:
                shutil.rmtree(fmt.step_dir(self.directory, s), ignore_errors=True)
        # orphaned stages of crashed saves whose step has committed or passed
        for name in attempt_dirs:
            s = fmt.parse_step(name.split(".attempt_")[0])
            if s is not None and s <= newest:
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

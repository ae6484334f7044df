"""Checkpoint I/O of the port (port of ``repro.io``): the reference's
format v2 (per-process shard files, manifest, COMMIT) and legacy v1 npz,
byte for byte, so either package restores what the other saved.

Public API:
  * ``save_checkpoint`` / ``restore_checkpoint``: synchronous save (v2 by
    default; ``fmt_version="npz"`` writes v1) and format-dispatching restore;
  * ``AsyncCheckpointWriter``: double-buffered background writer;
  * ``CheckpointManager``: async saves + keep_last / keep_every retention;
  * ``latest_step`` / ``list_steps``: complete steps (COMMIT-validated);
  * ``tree_structure_repr``: the manifest's structure string of a state.
"""

from repro_torch.io.format import latest_step, list_steps
from repro_torch.io.tree import structure_repr as tree_structure_repr
from repro_torch.io.manager import CheckpointManager
from repro_torch.io.reader import restore_checkpoint
from repro_torch.io.writer import AsyncCheckpointWriter, save_checkpoint, snapshot_tree

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "list_steps",
    "CheckpointManager",
    "AsyncCheckpointWriter",
    "snapshot_tree",
    "tree_structure_repr",
]

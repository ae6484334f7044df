"""Checkpoints of the recurrent archs cross between the port and the
reference: reduced xlstm-125m and hymba-1.5b (five units of runs),
``tests/test_torch_io_archs.py``'s check (its ``cross_both_ways``), in a file
of their own so that no one file holds the suite's longest run.

Also here, with ``tests/test_torch_io.py``'s helpers: the async writer,
retention and GC, the re-save and repair protocol, and restored leaves'
lifetime."""

import os
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.io import (  # noqa: E402
    CheckpointManager,
    format as ckfmt,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    writer,
)
from test_torch_io import (  # noqa: E402
    _nonzero_state,
    _steps_on_disk,
    _target_of,
    assert_leaves_equal,
    meta_like,
    port_leaves,
)
from test_torch_io_archs import cross_both_ways  # noqa: E402


@pytest.mark.parametrize("arch", ["xlstm-125m", "hymba-1.5b"])
def test_arch_checkpoints_cross_both_ways(arch, tmp_path):
    cross_both_ways(arch, tmp_path)


def test_async_save_returns_before_serialization(tmp_path, monkeypatch):
    """save() blocks only on the snapshot; COMMIT lands at wait(), and a
    second save proceeds while the first is written (double buffering)."""
    gate, started = threading.Event(), threading.Event()
    real = writer.write_snapshot

    def gated(directory, step, snap, extra=None):
        started.set()
        assert gate.wait(30), "test gate never opened"
        return real(directory, step, snap, extra)

    monkeypatch.setattr(writer, "write_snapshot", gated)
    tree = {"w": torch.arange(4096, dtype=torch.float32)}
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d)
    mgr.save(1, tree)
    assert started.wait(30), "background writer never started"
    assert not os.path.exists(os.path.join(d, "step_00000001", "COMMIT"))
    second_done = threading.Event()
    t = threading.Thread(target=lambda: (mgr.save(2, tree), second_done.set()), daemon=True)
    t.start()
    assert second_done.wait(30), "second save blocked: the writer is not double-buffered"
    gate.set()
    mgr.wait()
    t.join(30)
    assert not t.is_alive()
    assert os.path.exists(os.path.join(d, "step_00000002", "COMMIT"))
    assert latest_step(d) == 2
    assert set(mgr.commit_times) == {1, 2}


def test_async_writer_surfaces_errors(tmp_path, monkeypatch):
    def boom(directory, step, snap, extra=None):
        raise RuntimeError("disk on fire")

    monkeypatch.setattr(writer, "write_snapshot", boom)
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, {"w": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="disk on fire"):
        mgr.wait()


def test_post_commit_hook_failure_only_warns(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "c"))

    def bad_gc(step):
        raise OSError("gc failed")

    monkeypatch.setattr(mgr._writer, "_on_commit", bad_gc)
    with pytest.warns(UserWarning, match="post-commit hook failed"):
        mgr.save(1, {"w": torch.zeros(4)}, block=True)
    assert latest_step(str(tmp_path / "c")) == 1


def test_async_roundtrip_through_manager(tmp_path):
    state, cfg = _nonzero_state("adamw4bit")
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(3, state, extra={"k": 1})
    restored, extra = mgr.restore(_target_of(state, cfg, "adamw4bit"), device="cpu")
    assert extra == {"k": 1}
    assert_leaves_equal(port_leaves(restored), port_leaves(state), "manager roundtrip")


def test_retention_keep_last_and_keep_every(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d, keep_last=2, keep_every=4)
    for s in range(1, 9):
        mgr.save(s, tree, block=True)
    assert _steps_on_disk(d) == [4, 7, 8]
    restored, _ = restore_checkpoint(d, meta_like(tree), step=4, device="cpu")
    assert torch.equal(restored["w"], tree["w"])


def test_gc_never_deletes_newest_complete(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d, keep_last=1)
    mgr.save(1, tree, block=True)
    assert _steps_on_disk(d) == [1]
    mgr.save(2, tree, block=True)
    assert _steps_on_disk(d) == [2]


def test_resave_keeps_durable_copy_until_commit(tmp_path, monkeypatch):
    """A re-save of a committed step stages elsewhere: a kill before its
    COMMIT leaves the original intact; the retry replaces it."""
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    d = str(tmp_path / "c")
    path = save_checkpoint(d, 1, tree)
    real = writer._barrier

    def dying_barrier(name):
        if name.startswith("ckpt_written"):
            raise RuntimeError("killed between shard write and COMMIT")
        return real(name)

    monkeypatch.setattr(writer, "_barrier", dying_barrier)
    with pytest.raises(RuntimeError, match="killed"):
        save_checkpoint(d, 1, {"w": tree["w"] * 2})
    assert ckfmt.is_complete(path) and latest_step(d) == 1
    assert any(".attempt_" in n for n in os.listdir(d))
    restored, _ = restore_checkpoint(d, meta_like(tree), device="cpu")
    assert torch.equal(restored["w"], tree["w"])

    monkeypatch.setattr(writer, "_barrier", real)
    new_tree = {"w": tree["w"] * 2}
    save_checkpoint(d, 1, new_tree)
    assert ckfmt.is_complete(path)
    assert not os.path.exists(path + ".replaced"), "backup not cleaned up"
    restored, _ = restore_checkpoint(d, meta_like(tree), device="cpu")
    assert torch.equal(restored["w"], new_tree["w"])


def test_repair_restores_set_aside_copy(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    d = str(tmp_path / "c")
    path = save_checkpoint(d, 1, tree)
    os.rename(path, path + ".replaced")  # the mid-swap kill
    assert latest_step(d) == 1
    assert ckfmt.is_complete(path) and not os.path.exists(path + ".replaced")
    restored, _ = restore_checkpoint(d, meta_like(tree), device="cpu")
    assert torch.equal(restored["w"], tree["w"])


def test_gc_drops_abandoned_timeline_after_rewind(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d, keep_last=3)
    for s in (10, 20, 30):
        mgr.save(s, tree, block=True)
    mgr.save(15, tree, block=True)  # rewound to 10, replayed to 15
    assert _steps_on_disk(d) == [10, 15]
    assert latest_step(d) == 15


def test_gc_sweeps_crash_leftovers(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d, keep_last=3)
    mgr.save(1, tree, block=True)
    crashed = save_checkpoint(d, 2, tree)
    os.remove(os.path.join(crashed, "COMMIT"))
    mgr.save(3, tree, block=True)
    assert _steps_on_disk(d) == [1, 3]


def test_restored_leaves_die_with_the_state(tmp_path):
    """Walking a tree leaves no reference cycle behind: once the caller
    drops a restored state, its leaves are freed at once, not at the next
    cyclic collection (a resumed run kept its first state a step longer)."""
    import gc
    import weakref

    tree = {"a": {"b": torch.arange(6, dtype=torch.float32)}, "c": torch.ones(3)}
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, tree)
    gc.collect()
    gc.disable()
    try:
        restored, _ = restore_checkpoint(d, {"a": {"b": torch.empty(6, device="meta")},
                                             "c": torch.empty(3, device="meta")}, device="cpu")
        refs = [weakref.ref(v) for v in (restored["a"]["b"], restored["c"])]
        del restored
        assert all(r() is None for r in refs)
    finally:
        gc.enable()

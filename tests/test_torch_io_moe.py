"""Checkpoints of the MoE archs cross between the port and the reference:
reduced phi3.5-moe and mixtral (``moe/router``, ``moe/w1``-``w3`` leaves,
the expert stacks' 4-bit moments with one rank-1 stat per dim),
``tests/test_torch_io_archs.py``'s check (its ``cross_both_ways``).

Also here, with ``tests/test_torch_io.py``'s helpers: the manifest's
schema and incomplete, truncated and corrupt saves (pytest-xdist's
``--dist loadfile`` hands out the files with the most tests first).
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.io import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402
from test_torch_io import meta_like  # noqa: E402
from test_torch_io_archs import cross_both_ways  # noqa: E402


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "mixtral-8x7b"])
def test_arch_checkpoints_cross_both_ways(arch, tmp_path):
    cross_both_ways(arch, tmp_path)


def test_manifest_v2_schema(tmp_path):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "n": torch.tensor(3, dtype=torch.int32)}
    d = str(tmp_path / "c")
    path = save_checkpoint(d, 5, tree, extra={"note": "hi"})
    assert sorted(os.listdir(path)) == ["COMMIT", "host_00000.bin", "index_host_00000.json",
                                        "manifest.json"]
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["format_version"] == 2
    assert manifest["step"] == 5 and manifest["extra"] == {"note": "hi"}
    assert manifest["num_hosts"] == 1
    assert manifest["structure"] == "PyTreeDef({'n': *, 'w': *})"
    by_key = {m["key"]: m for m in manifest["leaves"]}
    assert by_key["['w']"]["shape"] == [3, 4] and by_key["['w']"]["dtype"] == "float32"
    assert by_key["['n']"]["shape"] == [] and by_key["['n']"]["dtype"] == "int32"
    idx = json.load(open(os.path.join(path, "index_host_00000.json")))
    assert idx["process"] == 0
    recs = idx["shards"]["['w']"]
    assert sum(r["nbytes"] for r in recs) == 12 * 4
    for r in recs:
        assert len(r["index"]) == 2 and len(r["sha256"]) == 16
    assert idx["shards"]["['n']"][0]["index"] == []
    assert latest_step(d) == 5


def test_incomplete_dir_ignored_and_fallback(tmp_path):
    """A save killed mid-shard-write (truncated bin, no COMMIT) is invisible
    to latest_step; restore lands on the last complete step."""
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    d = str(tmp_path / "c")
    save_checkpoint(d, 5, tree)
    crashed = save_checkpoint(d, 9, tree)
    os.remove(os.path.join(crashed, "COMMIT"))
    bin_path = os.path.join(crashed, "host_00000.bin")
    with open(bin_path, "r+b") as f:
        f.truncate(os.path.getsize(bin_path) // 2)
    assert latest_step(d) == 5  # LATEST still says 9
    restored, _ = restore_checkpoint(d, meta_like(tree), device="cpu")
    assert torch.equal(restored["w"], tree["w"])


def test_truncated_shard_with_commit_raises(tmp_path):
    """Truncation behind a COMMIT is corruption: restore raises."""
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    d = str(tmp_path / "c")
    path = save_checkpoint(d, 1, tree)
    bin_path = os.path.join(path, "host_00000.bin")
    with open(bin_path, "r+b") as f:
        f.truncate(os.path.getsize(bin_path) - 8)
    with pytest.raises(IOError, match="truncated"):
        restore_checkpoint(d, meta_like(tree), device="cpu")


def test_corrupted_shard_raises_hash_mismatch(tmp_path):
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    d = str(tmp_path / "c")
    path = save_checkpoint(d, 1, tree)
    with open(os.path.join(path, "host_00000.bin"), "r+b") as f:
        f.seek(8)
        f.write(b"\xff")
    with pytest.raises(IOError, match="hash mismatch"):
        restore_checkpoint(d, meta_like(tree), device="cpu")
    restored, _ = restore_checkpoint(d, meta_like(tree), device="cpu", validate=False)
    assert not torch.equal(restored["w"], tree["w"])

"""What a run loads: nothing whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (names compared whole: the program ``repro_torch``
begins with ``repro``), and the reference loads nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
PATHS = [str(BENCH), str(BENCH.parent / "src")]


def _modules_after(code: str):
    prog = (f"import sys; sys.path[:0] = {PATHS!r}\n{code}\n"
            "import json; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         cwd=BENCH.parent, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_reference_package():
    mods = _modules_after(
        "from pathlib import Path\nimport harness\n"
        "rc = harness.main(['--workload', 'tiny-dense.tiny', '--seed', '5', '--seconds', '0.2'],"
        " bench_file=Path('bench/tests/data/bench_cpu.json'), data=Path('bench/tests/data'),"
        " device='cpu')\nassert rc == 0")
    top = {m.split(".")[0] for m in mods}
    assert "repro_torch" in top  # the run drove the program
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after("import check, control, weights, traffic, yardstick, devtrace\n"
                          "from reference import model, optim, quant, threefry")
    top = {m.split(".")[0] for m in mods}
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}

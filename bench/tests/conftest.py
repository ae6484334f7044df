"""The benchmark's tests import its modules by name, as ``bench/run.py``
does: the benchmark's folder and the program's ``src`` go first on the path."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

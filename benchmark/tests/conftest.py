"""The benchmark's own tests: the harness, its yardstick and its plain
references, on the CPU at small sizes; tests marked `gpu` need a CUDA
device and skip without one.

    python -m pytest -q benchmark/tests
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")

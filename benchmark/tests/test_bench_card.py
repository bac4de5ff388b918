"""On the card: the control, the port's TF32 route (`control=True`),
comes out not correct in every cell at the cell's own size on three seeds,
and the command runs a cell through to its result line.  Every test here
needs a CUDA device and skips without one:

    python -m pytest -q -p no:cacheprovider benchmark/tests/test_bench_card.py
"""

import json
import subprocess
import sys
import time

import pytest
import torch
from harness import runner
from harness.registry import Registry

from conftest import BENCH, ROOT

pytestmark = pytest.mark.gpu

CELLS = [w["name"] for w in Registry(ROOT).spec["workloads"]]
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs on the card only")


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    for seed in SEEDS:
        result, _, _ = runner.run_cell(ROOT, cell, seed, 2.0, False, "cuda", time.perf_counter(),
                                       control=True)
        assert not result["correct"], (seed, result["checks"])


def test_command_runs_a_cell(card):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "flagship16k.query",
                          "--seed", str(2**31 + 21), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert set(line["metrics"]) == {m["name"] for m in Registry(ROOT).metrics("flagship16k.query", True)}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")

"""A configuration, a traffic mix and a metric are added as new files and
new entries in a copy of the benchmark, and the harness runs the new cell
(rehearsed on the CPU) without an edit to any file that was there."""

import hashlib
import json
import shutil
import time
from pathlib import Path

from harness import runner

from conftest import BENCH, ROOT

NEW_REFERENCE = '''"""The flagship's reference, at another size."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("flagship16k_ref", Path(__file__).with_name("flagship16k.py"))
_ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ref)
leaves, value_and_grad, marginals = _ref.leaves, _ref.value_and_grad, _ref.marginals
'''

NEW_METRIC = '''"""Requests a second over the window."""


def read(run):
    w = run["window"]
    return w["units"] / w["window_s"] if run["kind"] == "query" and w["units"] else None
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_make_a_new_cell(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "traces", ".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    bench = root / "benchmark"

    cfg = json.loads((bench / "configs" / "flagship16k.json").read_text())
    cfg["n"] = 192
    (bench / "configs" / "flagship192.json").write_text(json.dumps(cfg))
    (bench / "reference" / "flagship192.py").write_text(NEW_REFERENCE)
    (bench / "traffic" / "query_small.json").write_text(json.dumps(
        {"kind": "query", "points": 16, "warmup_requests": 1,
         "sample": 2, "trace_units": 4}))
    (bench / "limits" / "flagship192.query_small.json").write_text(json.dumps({"mean": 1e-3, "var": 1e-3}))
    (bench / "metrics" / "requests_per_s.py").write_text(NEW_METRIC)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "flagship192", "source": "https://example.org/flagship",
                            "file": "benchmark/configs/flagship192.json", "reduced": ["n"], "why": "tiny"})
    spec["workloads"].append({"name": "flagship192.query_small", "config": "flagship192",
                              "traffic": "query_small", "chips": 1, "why": "tiny"})
    spec["end_to_end"].append({"name": "requests_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["flagship192.query_small"]})
    for m in spec["end_to_end"]:
        if m["name"] in ("request_p95_ms", "points_per_s"):
            m["workloads"].append("flagship192.query_small")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    result, run, ctx = runner.run_cell(root, "flagship192.query_small", 11, 0.3, False, "cpu",
                                       time.perf_counter())
    assert result["correct"], result["checks"]
    metrics = runner.read_metrics(ctx, run, traced=False)
    assert set(metrics) == {"setup_s", "request_p95_ms", "points_per_s", "requests_per_s"}
    assert metrics["requests_per_s"]["unit"] == "1/s"
    after = _digests(root)
    # only BENCHMARK.json gained entries; no file that was there changed
    assert [p for p, d in before.items() if after.get(p) != d] == [Path("BENCHMARK.json")]
    assert {p for p in after if p not in before} >= {
        p.relative_to(root) for p in (bench / "configs" / "flagship192.json",
                                      bench / "reference" / "flagship192.py",
                                      bench / "traffic" / "query_small.json",
                                      bench / "metrics" / "requests_per_s.py")}

"""A configuration, a traffic mix and a metric are added as new files and
new entries in a copy of the benchmark, and the harness runs the new cell
(rehearsed on the CPU) without an edit to any file that was there: a query
cell under a new traffic mix and a new end-to-end metric, and a training
cell under the existing mix, appended to the lists of the metrics that move
`step_ms`, with a new per-layer metric that reads the program's spans.  The
benchmark's own checks of its cells' lists pass on the copy too.  A new
programme that reaches the port through a call no other adapter names
brings its own `half_batch`, and `faults.plant` finds it beside the
programme; a programme's own fault takes the place of the shared one."""

import hashlib
import json
import shutil
import time
import types
from pathlib import Path

import faults
import pytest
import test_bench_program_spans as spans_test
import test_bench_rehearsal as rehearsal
import torch
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

#: The flagship's model reached through `finite_gp.logpdf`, which neither
#: `faults.py` nor another adapter names, with its own `half_batch`.
LOGPDF_PROGRAMME = '''"""The flagship through `finite_gp.logpdf`."""
import importlib.util
from pathlib import Path

from harness.fit_problem import FitProblem

from stheno_tpu_torch import entry, finite_gp
from stheno_tpu_torch import params as P
from stheno_tpu_torch.inputs import GPPPInput

_spec = importlib.util.spec_from_file_location("flagship_adapter", Path(__file__).with_name("flagship.py"))
_flagship = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_flagship)
make_data, theta = _flagship.make_data, _flagship.theta


def fit_problem(cfg, data):
    theta0, unflatten = P.init({k: P.positive(v) for k, v in theta(cfg, data["x"].device).items()})

    def objective(th):
        t = unflatten(th)
        return -finite_gp.logpdf(entry.build(t)(GPPPInput("f3", data["x"]), t["noise"]), data["y"])

    return FitProblem(theta0, objective, "logpdf")


def half_batch():
    import faults

    return faults.halving({finite_gp: {"logpdf": faults.objective("fx", "y")}})
'''

LOGPDF_COUNTS = '''"""The flagship's counts."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("flagship_counts", Path(__file__).with_name("flagship.py"))
_counts = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_counts)
flops = _counts.flops
'''

NEW_METRIC = '''"""Requests a second over the window."""


def read(run):
    w = run["window"]
    return w["units"] / w["window_s"] if run["kind"] == "query" and w["units"] else None
'''

NEW_SPAN_METRIC = '''"""Host milliseconds a fit step spends inside the program's spans."""
from harness.program_spans import host_ms
from harness.readings import FIT


def read(run):
    return host_ms(run, FIT)
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _copy(tmp_path):
    """A checkout of the benchmark without its tests: its root, its folder
    and the digest of each file."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "traces", ".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root, root / "benchmark", _digests(root)


def _join_training_cell(root, cell, config):
    """`BENCHMARK.json` with `config` and its cell under the `train` mix,
    appended to `step_ms` and to each per-layer metric that moves it."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": config, "source": "https://example.org/flagship",
                            "file": f"benchmark/configs/{config}.json", "reduced": ["n"], "why": "tiny"})
    spec["workloads"].append({"name": cell, "config": config, "traffic": "train", "chips": 1,
                              "why": "tiny"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "step_ms" in (m["name"], m.get("moves")):
            m["workloads"].append(cell)
    return spec


def _trace_on_the_cpu(monkeypatch):
    """A traced run without a card: the profiler records the host, the
    marker kernel is a host span of its name, and the host's operations
    stand in for the device's."""
    from torch.profiler import ProfilerActivity, record_function

    profile, events = torch.profiler.profile, runner._events

    def mark(cycles):
        with record_function(runner.MARK_KERNEL):
            pass

    def host_events(prof):
        ops = [e if e.name.startswith(runner.SPAN_PREFIX) else
               types.SimpleNamespace(name=e.name, time_range=e.time_range,
                                     device_type=torch.autograd.DeviceType.CUDA)
               for e in prof.events()]
        return events(types.SimpleNamespace(events=lambda: ops))

    monkeypatch.setattr(torch.profiler, "profile",
                        lambda activities: profile(activities=[ProfilerActivity.CPU]))
    monkeypatch.setattr(torch.cuda, "_sleep", mark)
    monkeypatch.setattr(runner, "_events", host_events)


def test_new_files_make_a_new_cell(tmp_path):
    root, bench, before = _copy(tmp_path)

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


def test_new_files_make_a_new_training_cell(tmp_path, monkeypatch):
    from stheno_tpu_torch.utils import logging as tracer

    root, bench, before = _copy(tmp_path)
    cell = "flagship4k.train"
    cfg = json.loads((bench / "configs" / "flagship16k.json").read_text())
    cfg["n"] = 4096
    added = {bench / "configs" / "flagship4k.json": json.dumps(cfg),
             bench / "reference" / "flagship4k.py": NEW_REFERENCE,
             bench / "limits" / f"{cell}.json": (bench / "limits" / "flagship16k.train.json").read_text(),
             bench / "rehearsal" / f"{cell}.json": json.dumps({"config": {"n": 192}, "traffic": {}}),
             bench / "metrics" / "span_host_ms.train.py": NEW_SPAN_METRIC}
    for path, text in added.items():
        path.write_text(text)
    spec = _join_training_cell(root, cell, "flagship4k")
    spec["per_layer"].append({"name": "span_host_ms.train", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "programme and dispatch",
                              "moves": "step_ms", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    result, run, ctx = runner.run_cell(root, cell, 12, 0.3, False, "cpu", time.perf_counter(),
                                       rehearsal.tiny(cell, root))
    assert result["correct"], result["checks"]
    assert ctx.cfg["n"] == 192
    assert set(runner.read_metrics(ctx, run, traced=False)) == {"setup_s", "step_ms"}

    _trace_on_the_cpu(monkeypatch)
    tracer.clear()
    try:
        result, run, ctx = runner.run_cell(root, cell, 13, 0.3, True, "cpu", time.perf_counter(),
                                           rehearsal.tiny(cell, root))
        metrics = runner.read_metrics(ctx, run, traced=True)
    finally:
        tracer.clear()
    assert result["correct"], result["checks"]
    listed = {m["name"] for m in ctx.reg.metrics(cell, traced=True)}
    assert listed == {m["name"] for m in spec["per_layer"] if m["moves"] == "step_ms"}
    # the readers of the card's spans may read nothing on the CPU; the host's do
    assert {"step_mfu", "span_host_ms.train"} <= set(metrics) <= listed
    assert metrics["span_host_ms.train"]["value"] > 0

    rehearsal.test_every_cell_is_rehearsed(root)
    spans_test.test_readers_are_listed_for_their_cells(root)
    after = _digests(root)
    assert [p for p, d in before.items() if after.get(p) != d] == [Path("BENCHMARK.json")]
    assert {p.relative_to(root) for p in added} <= set(after) - set(before)


def test_a_programme_brings_its_own_half_batch(tmp_path):
    root, bench, before = _copy(tmp_path)
    cell = "logpdf4k.train"
    cfg = json.loads((bench / "configs" / "flagship16k.json").read_text())
    cfg.update(programme="flagship_logpdf", n=4096)
    added = {bench / "configs" / "logpdf4k.json": json.dumps(cfg),
             bench / "reference" / "logpdf4k.py": NEW_REFERENCE,
             bench / "programmes" / "flagship_logpdf.py": LOGPDF_PROGRAMME,
             bench / "counts" / "flagship_logpdf.py": LOGPDF_COUNTS,
             bench / "limits" / f"{cell}.json": (bench / "limits" / "flagship16k.train.json").read_text(),
             bench / "rehearsal" / f"{cell}.json": json.dumps({"config": {"n": 192}, "traffic": {}})}
    for path, text in added.items():
        path.write_text(text)
    (root / "BENCHMARK.json").write_text(json.dumps(_join_training_cell(root, cell, "logpdf4k")))

    def run(seed):
        result, _, _ = runner.run_cell(root, cell, seed, 0.3, False, "cpu", time.perf_counter(),
                                       rehearsal.tiny(cell, root))
        return result

    result = run(21)
    assert result["correct"], result["checks"]
    # the flagship's half_batch never reaches this programme's objective
    with faults.plant("half_batch", faults.programme_of(root, "flagship16k.train")):
        result = run(22)
    assert result["correct"], result["checks"]
    programme = faults.programme_of(root, cell)
    for fault in faults.BY_KIND["fit"]:
        with faults.plant(fault, programme):
            result = run(22)
        assert not result["correct"], (fault, result["checks"])

    del programme.half_batch
    with pytest.raises(NotImplementedError, match=r"benchmark/programmes/flagship_logpdf\.py defines no "
                                                  r"half_batch: write `def half_batch\(\):`"):
        faults.plant("half_batch", programme)
    rehearsal.test_every_cell_is_rehearsed(root)
    after = _digests(root)
    assert [p for p, d in before.items() if after.get(p) != d] == [Path("BENCHMARK.json")]
    assert {p.relative_to(root) for p in added} <= set(after) - set(before)


def test_a_programmes_own_fault_takes_the_place_of_the_shared_one():
    from stheno_tpu_torch import finite_gp

    shared_target, own_target = finite_gp.PosteriorGP.mean, finite_gp.FiniteGP.mean
    programme = faults.programme_of(ROOT, "flagship16k.query")
    programme.altered_answer = lambda: faults.altering({finite_gp.FiniteGP: ("mean",)})
    with faults.plant("altered_answer", programme):
        assert finite_gp.PosteriorGP.mean is shared_target
        assert finite_gp.FiniteGP.mean is not own_target
        result, _, _ = rehearsal.rehearse("flagship16k.query")
    assert not result["correct"], result["checks"]
    assert finite_gp.FiniteGP.mean is own_target

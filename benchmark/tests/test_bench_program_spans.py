"""The per-layer metrics that read the program's own spans
(`harness/program_spans.py` and its ten readers) against synthetic
records, and against the spans of rehearsed units on the CPU, whose device
events stand in on the host's clock."""

import pytest
import torch
from harness import program_spans as ps
from harness import runner
from harness.registry import Registry

from conftest import ROOT
from test_bench_rehearsal import CELLS, tiny

REG = Registry(ROOT)
TRAIN = ["flagship16k.train", "vfe131k.train"]
REQUESTS = ["flagship16k.query", "flagship16k.predict"]
#: Each reader, and the cells that listed it when this was written: a
#: floor, as a later cell joins by appending its name to these lists.
READERS = {
    "factor_ms.train": TRAIN, "reverse_ms.train": TRAIN, "subst_ms.train": TRAIN,
    "cov_ms.train": TRAIN, "chol_gemm_tflops.train": TRAIN,
    "factor_ms.request": ["flagship16k.predict"], "subst_ms.request": REQUESTS,
    "cov_ms.request": REQUESTS, "host_ms.request": REQUESTS,
}
#: The traffic kinds whose cells a per-layer metric may list, by the suffix
#: of its name, or by the end-to-end metric it moves where it has none.  A
#: query's posterior is built in set-up, untraced: no factor to read.
KINDS_BY_SUFFIX = {"train": {"fit"}, "request": {"query", "predict"}}
KINDS_BY_MOVES = {"step_ms": {"fit"}, "request_p95_ms": {"query", "predict"}}
KINDS_OF = {"factor_ms.request": {"predict"}}
#: A fit step's one root span, by the configuration's programme.
FIT_ROOTS = {"flagship": "logpdf", "pseudo_points": "elbo"}

MS = 1_000_000


class Calls:
    """Synthetic records, one call at a time, on a clock in ns."""

    def __init__(self):
        self.recs, self.next = [], 1

    def span(self, name, parent, host, device=None, **counts):
        sid = self.next
        self.next += 1
        trace = sid if parent is None else parent["trace"]
        rec = {"name": name, "id": sid, "parent": None if parent is None else parent["id"],
               "trace": trace, "thread": 1, "host_ns": host, "device_ns": device, "counts": counts}
        self.recs.append(rec)
        return rec

    def step(self, t, factor_ms, reverse_ms, name="logpdf"):
        """A fit step from t (ms): a cov block, the factor, a solve inside
        the root; then the reverse rules on another thread."""
        root = self.span(name, None, (t * MS, (t + 30) * MS), (t * MS, (t + 2 + factor_ms + 1) * MS))
        cov = self.span("cov", root, ((t + 1) * MS, (t + 2) * MS), (t * MS, (t + 2) * MS), elems=16)
        f = self.span("chol.factor", root, ((t + 2) * MS, (t + 20) * MS),
                      ((t + 2) * MS, (t + 2 + factor_ms) * MS), panels=4, gemm_flops=int(1e12 * factor_ms / 1e3))
        s = self.span("solve", root, ((t + 20) * MS, (t + 21) * MS),
                      ((t + 2 + factor_ms) * MS, (t + 3 + factor_ms) * MS))
        b = t + 40
        r = self.span("chol.reverse", f, (b * MS, (b + 10) * MS), (b * MS, (b + reverse_ms) * MS),
                      gemm_flops=int(2e12 * reverse_ms / 1e3))
        r["thread"] = 2
        self.span("solve.reverse", s, ((b + 10) * MS, (b + 11) * MS),
                  ((b + reverse_ms) * MS, (b + reverse_ms + 1) * MS))
        self.span("cov.reverse", cov, ((b + 11) * MS, (b + 12) * MS),
                  ((b + reverse_ms + 1) * MS, (b + reverse_ms + 3) * MS))


def traced(kind, units, unit, tries=1, warmup=None, first=None, annotated=None):
    """The run of a traced pass in the harness's order, its units made by
    `unit(i, t, part)` at t ms: the profiler's two warm-up units, then each
    try of the device-only pass (a unit before its marker, then `units`),
    then the annotated pass's `units`.  `warmup`, `first` and `annotated`
    stand in for `unit` in those parts where given."""
    parts = ([warmup or unit] * ps.WARMUP_UNITS
             + ([first or unit] + [unit] * units) * tries
             + [annotated or unit] * units)
    for i, make in enumerate(parts):
        make(i, 1000 * i)
    return {"kind": kind, "trace": {"units": units}}


@pytest.fixture
def planted(monkeypatch):
    calls = Calls()
    monkeypatch.setattr(ps, "records", lambda: list(calls.recs))
    return calls


def read(name, run):
    return REG.reader(name).read(run)


def kinds(metric):
    """The traffic kinds a per-layer metric's cells may have."""
    name = metric["name"]
    return (KINDS_OF.get(name) or KINDS_BY_SUFFIX.get(name.rpartition(".")[2])
            or KINDS_BY_MOVES[metric["moves"]])


def test_readers_are_listed_for_their_cells(root=ROOT):
    """Each span reader keeps the cells it had and reads what it did; every
    per-layer metric's list names cells that exist, that report the
    end-to-end metric it moves, and whose traffic is of its kind."""
    reg = Registry(root)
    cells = {w["name"]: reg.traffic(w["traffic"])["kind"] for w in reg.spec["workloads"]}
    reporting = {m["name"]: set(m.get("workloads", cells)) for m in reg.spec["end_to_end"]}
    listed = {m["name"]: m for m in reg.spec["per_layer"]}
    for name, floor in READERS.items():
        assert set(floor) <= set(listed[name]["workloads"]), name
        assert listed[name]["source"] == ("host_clock" if name.startswith("host_ms") else "device_trace")
        assert listed[name]["moves"] == ("step_ms" if name.endswith(".train") else "request_p95_ms")
    for m in listed.values():
        if "workloads" not in m:
            continue
        assert set(m["workloads"]) <= set(cells), m["name"]
        assert set(m["workloads"]) <= reporting[m["moves"]], m["name"]
        assert {cells[c] for c in m["workloads"]} <= kinds(m), m["name"]


def test_a_fit_step_by_layer(planted):
    run = traced("fit", 3, lambda i, t: planted.step(t, factor_ms=40, reverse_ms=90))
    assert read("factor_ms.train", run) == pytest.approx(40.0)
    assert read("reverse_ms.train", run) == pytest.approx(90.0)
    assert read("subst_ms.train", run) == pytest.approx(2.0)
    assert read("cov_ms.train", run) == pytest.approx(4.0)
    assert read("chol_gemm_tflops.train", run) == pytest.approx((40e9 + 180e9) / 130e-3 / 1e12)
    assert read("factor_ms.request", run) is None  # another kind's metric


@pytest.mark.parametrize("tries", [1, 2])
def test_only_the_device_only_window_is_read(planted, tries):
    """Three passes at three speeds, the device-only pass tried `tries`
    times: only its last window's units are read, slower or not."""

    def window(i, t):
        planted.step(t, factor_ms=40 + (i % 5) * 0.1, reverse_ms=90 + (i % 5))

    run = traced("fit", 3, window, tries=tries,
                 warmup=lambda i, t: planted.step(t, factor_ms=10, reverse_ms=20),
                 first=lambda i, t: planted.step(t, factor_ms=60, reverse_ms=120),
                 annotated=lambda i, t: planted.step(t, factor_ms=80, reverse_ms=150))
    n = ps.WARMUP_UNITS + tries * 4 + 3
    last = [i % 5 for i in range(n - 6, n - 3)]
    assert read("factor_ms.train", run) == pytest.approx(40 + sorted(last)[1] * 0.1)
    assert read("reverse_ms.train", run) == pytest.approx(90 + sorted(last)[1])


def test_records_out_of_the_harness_order_read_none(planted):
    for i in range(5):  # three units a pass need at least 2 + 4 + 3 calls
        planted.step(100 * i, factor_ms=40, reverse_ms=90)
    run = {"kind": "fit", "trace": {"units": 3}}
    assert read("factor_ms.train", run) is None
    for i in range(5, 10):  # 10 calls: no whole number of device-only tries
        planted.step(100 * i, factor_ms=40, reverse_ms=90)
    assert read("factor_ms.train", run) is None
    for i in range(10, 13):  # 13 calls: two tries
        planted.step(100 * i, factor_ms=40, reverse_ms=90)
    assert read("factor_ms.train", run) == pytest.approx(40.0)
    assert read("factor_ms.train", {"kind": "fit", "trace": None}) is None  # untraced


def test_two_top_level_names_are_summed(planted):
    def request(i, t):
        mean = planted.span("posterior.mean", None, (t * MS, (t + 2) * MS), (t * MS, (t + 5) * MS))
        planted.span("cov", mean, (t * MS, (t + 1) * MS), (t * MS, (t + 3) * MS), elems=10)
        var = planted.span("posterior.var", None, ((t + 5) * MS, (t + 9) * MS), ((t + 5) * MS, (t + 30) * MS))
        planted.span("cov", var, ((t + 5) * MS, (t + 6) * MS), ((t + 5) * MS, (t + 7) * MS))
        planted.span("solve", var, ((t + 6) * MS, (t + 8) * MS), ((t + 7) * MS, (t + 29) * MS))

    run = traced("query", 2, request)
    assert read("cov_ms.request", run) == pytest.approx(3.0 + 2.0)
    assert read("subst_ms.request", run) == pytest.approx(22.0)
    assert read("host_ms.request", run) == pytest.approx(2.0 + 4.0)
    assert read("factor_ms.request", run) is None  # the query's posterior is built untraced


def test_nested_spans_of_one_name_count_once(planted):
    def request(i, t):
        t *= MS
        root = planted.span("entry.predict", None, (t, t + 50 * MS), (t, t + 50 * MS))
        post = planted.span("posterior", root, (t, t + 20 * MS), (t, t + 20 * MS))
        outer = planted.span("cov", post, (t, t + 10 * MS), (t, t + 10 * MS))
        planted.span("cov", outer, (t, t + 5 * MS), (t, t + 5 * MS))
        planted.span("chol.factor", post, (t + 10 * MS, t + 20 * MS), (t + 10 * MS, t + 18 * MS))

    run = traced("predict", 1, request)
    assert read("cov_ms.request", run) == pytest.approx(10.0)
    assert read("factor_ms.request", run) == pytest.approx(8.0)


def test_nothing_recorded_reads_none(planted, monkeypatch):
    for name in READERS:
        for kind in ("fit", "query", "predict"):
            assert read(name, {"kind": kind, "trace": {"units": 1}}) is None

    def request(i, t):  # spans without device intervals (no card)
        root = planted.span("entry.predict", None, (t * MS, (t + 1) * MS))
        planted.span("chol.factor", root, (t * MS, (t + 1) * MS))

    run = traced("predict", 1, request)
    assert read("factor_ms.request", run) is None  # the device metrics read None
    assert read("host_ms.request", run) == pytest.approx(1.0)


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    from stheno_tpu_torch.utils import logging as tracer

    monkeypatch.delattr(tracer, "spans")
    assert ps.records() == []
    for name in READERS:
        for kind in ("fit", "predict"):
            assert read(name, {"kind": kind, "trace": {"units": 1}}) is None


class _HostEvent:
    """A timing event on the host's clock, in place of the card's."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        import time

        self.t = time.time_ns()

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsed_units_give_every_listed_reading(cell, monkeypatch):
    """Units of each cell rehearsed on the CPU under `recording()`, with
    stand-in device events: each of the cell's readers finds its reading,
    and the layers of a step fit inside the step, under one root."""
    from stheno_tpu_torch import config
    from stheno_tpu_torch.utils import logging as tracer

    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    ctx = runner.Context(REG, cell, 2**31 + 5, "cpu", tiny(cell))
    tracer.clear()
    try:
        with config.chol_backend("blocked"):
            st = ctx.driver.setup(ctx)
            with tracer.recording():  # the harness's order at one unit a pass
                for _ in range(ps.WARMUP_UNITS + 2 + 1):
                    ctx.driver.unit(ctx, st)
        run = {"kind": ctx.kind, "trace": {"units": 1}}
        values = {m["name"]: REG.reader(m["name"]).read(run) for m in REG.metrics(cell, traced=True)
                  if m["name"] in READERS}
        assert all(v is not None and v > 0 for v in values.values()), values
        if ctx.kind == "fit":
            parts = sum(values.get(f"{k}_ms.train", 0) for k in ("factor", "reverse", "subst", "cov"))
            (root,) = {r["name"] for r in tracer.spans() if r["parent"] is None}
            assert root == FIT_ROOTS.get(ctx.cfg["programme"], root)
            assert parts <= ps.host_ms(run, (ctx.kind,)) * 1.05
    finally:
        tracer.clear()

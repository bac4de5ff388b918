"""The port's tracer (`stheno_tpu_torch/utils/logging.py`): spans, their
tree and clock, the counts, the launch counters and the exporter, on the
CPU; the tests marked `gpu` hold the device intervals against the
profiler's kernels on the card and skip without one.  The file imports
neither JAX nor the JAX package:

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_tracing.py
"""

import collections
import json
import threading
import types

import numpy as np
import pytest
import torch

from stheno_tpu_torch import config, entry
from stheno_tpu_torch import params as P
from stheno_tpu_torch.cuda import _build
from stheno_tpu_torch.cuda import kernelmatrix as tkm
from stheno_tpu_torch.ops import blocked_cholesky as tbc
from stheno_tpu_torch.utils import logging as T


@pytest.fixture(autouse=True)
def fresh():
    T.clear()
    yield
    T.clear()


def _flagship(n=512, dtype=torch.float64, device="cpu"):
    x, y, _, theta = entry.flagship_data(n, 16, dtype, device)
    return x, y, theta


def _step(x, y, theta):
    leaves = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
    val = entry.nlml(leaves, x, y)
    return val, leaves


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def test_span_tree_has_ids_parents_and_one_trace_a_call():
    x, y, theta = _flagship()
    with config.chol_backend("blocked"), T.recording():
        for _ in range(2):
            val, leaves = _step(x, y, theta)
            torch.autograd.grad(val, list(leaves.values()))
    recs = T.spans()
    ids = [r["id"] for r in recs]
    assert len(set(ids)) == len(ids)
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["logpdf", "logpdf"]
    assert all(r["trace"] == r["id"] for r in roots)
    for root in roots:
        call = [r for r in recs if r["trace"] == root["id"]]
        got = _by_name(call)
        assert sorted(got) == ["chol.factor", "chol.reverse", "cov", "cov.reverse", "graph.reverse",
                               "logpdf", "solve", "solve.reverse"]
        (cov,), (factor,), (solve,) = got["cov"], got["chol.factor"], got["solve"]
        assert cov["parent"] == factor["parent"] == solve["parent"] == root["id"]
        # a reverse rule's span is a child of the span its forward ran in
        assert got["chol.reverse"][0]["parent"] == factor["id"]
        assert got["graph.reverse"][0]["parent"] == cov["id"]
        assert got["solve.reverse"][0]["parent"] == solve["id"]
        assert [r["parent"] for r in got["cov.reverse"]] == [cov["id"]] * 2  # f1's and f2's kernel
        for r in call:
            assert r["host_ns"][0] <= r["host_ns"][1]
            assert r["device_ns"] is None  # no CUDA here
        assert cov["counts"]["elems"] == x.numel() ** 2
        assert factor["counts"]["panels"] > 0 and factor["counts"]["gemm_flops"] > 0
    assert roots[0]["trace"] != roots[1]["trace"]


def test_reverse_rule_on_another_thread_keeps_its_parent():
    """Autograd runs a card's reverse rules on a thread of its own: the
    reverse span still names the forward's span, and records there although
    that thread never entered `recording()`."""
    x, y, theta = _flagship()
    with config.chol_backend("blocked"), T.recording():
        val, leaves = _step(x, y, theta)
    worker = threading.Thread(target=lambda: torch.autograd.grad(val, list(leaves.values())))
    worker.start()
    worker.join()
    got = _by_name(T.spans())
    (factor,), (rev,) = got["chol.factor"], got["chol.reverse"]
    assert rev["parent"] == factor["id"] and rev["trace"] == factor["trace"]
    assert rev["thread"] != factor["thread"]


class _FakeEvent:
    """A timing event on the host's clock: what the CPU can stand in for."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = T.time.time_ns()

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


def _fake_card(monkeypatch):
    _FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)


def test_off_records_nothing_reads_no_clock_and_makes_no_event(monkeypatch):
    _fake_card(monkeypatch)
    reads = []
    clock = types.SimpleNamespace(time_ns=lambda: reads.append(1) or 0)
    monkeypatch.setattr(T, "time", clock)
    x, y, theta = _flagship()
    assert T.span("a") is T.span("b")  # one shared null context
    with config.chol_backend("blocked"):
        val, leaves = _step(x, y, theta)
        torch.autograd.grad(val, list(leaves.values()))
    assert T.spans() == [] and _FakeEvent.made == 0 and reads == [] and T.active == 0


def test_on_a_device_a_span_records_its_interval(monkeypatch):
    _fake_card(monkeypatch)
    anchors = []
    take = T._anchor
    monkeypatch.setattr(T, "_anchor", lambda dev: anchors.append(take(dev)) or anchors[-1])
    x, y, theta = _flagship()
    with config.chol_backend("blocked"), T.recording():
        _step(x, y, theta)
    recs = T.spans()
    assert _FakeEvent.made == 1 + 2 * len(recs)  # a pair a span, then the anchor
    ((event, host),) = anchors
    off = host - event.t  # the anchor's own error: its host time read after its event
    for r in recs:
        (h0, h1), (d0, d1) = r["host_ns"], r["device_ns"]
        # the fake device runs on the host's clock: its events fall inside the
        # span, shifted by the anchor's error (1 ns for rounding)
        assert h0 - 1 <= d0 - off <= d1 - off <= h1 + 1
    # events already read are recorded again, not made anew
    with config.chol_backend("blocked"), T.recording():
        _step(x, y, theta)
    assert _FakeEvent.made == 1 + 2 * len(recs) and len(T.spans()) == 2 * len(recs)


def test_nothing_waits_for_the_device_until_the_spans_are_read(monkeypatch):
    _fake_card(monkeypatch)
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: syncs.append(device))
    x, y, theta = _flagship()
    with config.chol_backend("blocked"), T.recording():
        val, leaves = _step(x, y, theta)
        torch.autograd.grad(val, list(leaves.values()))
    assert syncs == []
    recs = T.spans()
    assert syncs == [0, 0]  # the anchor: before its event, and after
    assert recs and all(r["device_ns"] is not None for r in recs)


def test_the_store_keeps_the_newest_spans(monkeypatch):
    assert T._records.maxlen == T.MAX_RECORDS
    monkeypatch.setattr(T, "_records", collections.deque(maxlen=3))
    with T.recording():
        for i in range(5):
            with T.span(f"s{i}"):
                pass
    assert [r["name"] for r in T.spans()] == ["s2", "s3", "s4"]


def test_no_events_under_stream_capture(monkeypatch):
    _fake_card(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with T.recording(), T.span("captured"):
        pass
    (rec,) = T.spans()
    assert rec["device_ns"] is None and _FakeEvent.made == 0


def test_recording_nests_and_is_per_thread():
    seen = {}

    def other(tag):
        with T.span(f"other.{tag}"):
            pass
        seen[tag] = threading.get_native_id()

    with T.recording():
        with T.recording():
            with T.span("inner"):
                pass
        with T.span("outer"):
            worker = threading.Thread(target=other, args=("off",))
            worker.start()
            worker.join()
    with T.span("after"):
        pass

    def recorded():
        with T.recording(), T.span("own"):
            seen["own"] = threading.get_native_id()

    worker = threading.Thread(target=recorded)
    worker.start()
    worker.join()
    got = _by_name(T.spans())
    assert sorted(got) == ["inner", "outer", "own"]
    assert got["own"][0]["thread"] == seen["own"] != got["outer"][0]["thread"]
    assert got["own"][0]["parent"] is None and got["own"][0]["trace"] == got["own"][0]["id"]


def test_threads_open_spans_at_once(monkeypatch):
    """More threads than cores open and close nested spans while the
    interpreter switches threads as often as it can: the count of open
    spans comes back to zero, and each span's parent is on its own thread."""
    import os
    import sys

    workers, rounds = 4 * (os.cpu_count() or 1), 200

    def work():
        with T.recording():
            for _ in range(rounds):
                with T.span("outer"):
                    with T.span("inner"):
                        T.credit("elems", 1)

    # room for every span, whatever the number of cores
    monkeypatch.setattr(T, "_records", collections.deque(maxlen=2 * workers * rounds))
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    recs = T.spans()
    by_id = {r["id"]: r for r in recs}
    assert T.active == 0 and len(recs) == 2 * workers * rounds
    for r in recs:
        if r["name"] == "inner":
            parent = by_id[r["parent"]]
            assert parent["name"] == "outer" and parent["thread"] == r["thread"]
            assert r["counts"] == {"elems": 1} and parent["counts"] == {}


def test_a_recording_profiler_switches_spans_on():
    from torch.profiler import ProfilerActivity, profile

    with T.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with T.span("profiled"):
            with T.span("nested"):
                pass
    with T.span("after"):
        pass
    got = _by_name(T.spans())
    assert sorted(got) == ["nested", "profiled"]
    assert got["nested"][0]["parent"] == got["profiled"][0]["id"]


def test_spans_share_the_profilers_clock():
    """A `record_function` inside a span lies inside the span's host
    interval on kineto's own clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.span("outer"):
            with record_function("inside"):
                torch.ones(64, 64).sum()
    (rec,) = T.spans()
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inside"]
    h0, h1 = rec["host_ns"]
    assert h0 <= ev.start_ns() <= ev.end_ns() <= h1


def _forward_panels(n, block=1024, base=256):
    """Panels of `_blocked_cholesky_impl` worked out by hand: n/B at this
    level, and those of each diagonal block's factor at width max(base, B/4)."""
    if n <= base:
        return 0
    B = (min(block, n // 2) // 64) * 64
    return n // B + (n // B) * _forward_panels(B, max(base, B // 4), base)


@pytest.mark.parametrize("mode", ["iter", "fused"])
def test_panels_of_the_factor_and_its_reverse_sweeps(mode):
    n = 2048
    assert _forward_panels(n) == 2 + 2 * 4  # 2 panels of 1024, each factored in 4 of 256
    rng = np.random.default_rng(0)
    G = rng.normal(size=(n, n))
    A = torch.as_tensor(G @ G.T / n + np.eye(n)).requires_grad_(True)
    with config.chol_backend("blocked"), config.bwd_params(block=512, mode=mode), T.recording():
        from stheno_tpu_torch.ops.chol import cholesky_psd

        L = cholesky_psd(A)
        L.sum().backward()
    got = _by_name(T.spans())
    assert got["chol.factor"][0]["counts"]["panels"] == _forward_panels(n)
    assert got["chol.reverse"][0]["counts"]["panels"] == n // 512


def test_gemm_flops_are_the_products_of_the_gemms(monkeypatch):
    """The GEMMs go through `_mm`, or, in the blocked substitution, through
    `_mm_sub` (c − a @ b) and `_mm_into` (out ← a @ b), which credit their
    products themselves at 'highest'."""
    shapes = []

    def watch(name):
        gemm = getattr(tbc, name)

        def watched(*args):
            a, b = args[-2:]
            shapes.append((tuple(a.shape), tuple(b.shape)))
            return gemm(*args)

        monkeypatch.setattr(tbc, name, watched)

    for name in ("_mm", "_mm_sub", "_mm_into"):
        watch(name)
    x, y, theta = _flagship(1024)
    with config.chol_backend("blocked"), config.bwd_params(block=256), T.recording():
        val, leaves = _step(x, y, theta)
        torch.autograd.grad(val, list(leaves.values()))
    expected = 0
    for a, b in shapes:
        k, n = a[-1], (b[-1] if len(b) > 1 else 1)
        batch = int(np.prod(np.broadcast_shapes(a[:-2], b[:-2]), dtype=np.int64))
        expected += 2 * batch * a[-2] * k * n
    assert shapes and sum(r["counts"].get("gemm_flops", 0) for r in T.spans()) == expected


@pytest.mark.parametrize("where", ["tracer", "build"])
def test_launch_counter_keeps_its_interface_and_credits_the_span(where):
    cls = T.LaunchCounter if where == "tracer" else _build.LaunchCounter
    assert cls is T.LaunchCounter and isinstance(tkm.LAUNCHES, cls)
    c = cls("k")
    c.add((2, 3))
    with T.recording(), T.span("outer"):
        c.add((2, 3))
        with T.span("inner"):
            c.add((4, 5))
    assert c.total == 3 and c.by_shape == {(2, 3): 2, (4, 5): 1}
    got = _by_name(T.spans())
    assert got["outer"][0]["counts"] == {"launches.k": 1}
    assert got["inner"][0]["counts"] == {"launches.k": 1}
    c.reset()
    assert c.total == 0 and c.by_shape == {}


def test_spans_of_requests_and_the_pseudo_point_bound():
    x, y, theta = _flagship()
    xq = torch.linspace(-4.0, 4.0, 32, dtype=x.dtype)
    with config.chol_backend("blocked"), T.recording():
        entry.predict(theta, x, y, xq)
    recs = T.spans()
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "entry.predict" and {r["trace"] for r in recs} == {root["id"]}
    names = _by_name(recs)
    assert {"posterior", "posterior.mean", "posterior.var", "chol.factor", "solve", "cov"} <= set(names)
    T.clear()
    data = entry.pseudo_points_data(600, 24, torch.float64, "cpu", half_width=8.0)
    spec = entry.pseudo_points_spec(data[2])
    th, unflatten = P.init(spec)
    th = th.detach().requires_grad_(True)
    with T.recording():
        val = entry.pseudo_points_neg_elbo(unflatten(th), data)
        val.backward()
    got = _by_name(T.spans())
    (root,) = [r for r in T.spans() if r["parent"] is None]
    assert root["name"] == "elbo"
    assert len(got["chol.factor"]) == 2 and len(got["cov"]) == 3  # Kuu, Kuf, diag Kff
    # the substitution and its products reverse in one rule, under the bound
    (reverse,) = got["solve.reverse"]
    assert reverse["parent"] == root["id"] and reverse["counts"].get("vfe.fused") == 1


def _mauna_loa_step():
    """One value-and-gradient step of the two-output Mauna Loa programme at
    96 + 32 points (float64, the blocked route)."""
    data = entry.mauna_loa_data(96, 32, torch.float64, "cpu")
    theta0, _ = P.init(entry.mauna_loa_spec(torch.float64, "cpu"))
    with config.chol_backend("blocked"):
        return entry.mauna_loa_step(theta0, data)


def _inside(inner, outer):
    return outer["host_ns"][0] <= inner["host_ns"][0] <= inner["host_ns"][1] <= outer["host_ns"][1]


def test_stacked_blocks_are_a_cross_span_inside_cov():
    with T.recording():
        _mauna_loa_step()
    got = _by_name(T.spans())
    (root,), (cov,), (cross,) = got["logpdf"], got["cov"], got["cov.cross"]
    assert cov["parent"] == root["id"] and cross["parent"] == cov["id"] and _inside(cross, cov)
    assert cross["counts"] == {"blocks": 4, "elems": 128**2}  # co2², co2 × T, T × co2, T²
    assert cov["counts"] == {"elems": 128**2}  # kernel 1's launches credit the inner span


def test_the_graphs_reverse_is_one_span_holding_kernel1s_reverse_rules():
    """`graph.reverse` opens when the covariance's cotangent is ready (after
    the factor's reverse rule) and closes when the backward pass ends,
    under the forward's `cov` span; kernel 1's reverse rules run inside."""
    with T.recording():
        _mauna_loa_step()
    recs = T.spans()
    got = _by_name(recs)
    (root,), (cov,), (rev,) = got["logpdf"], got["cov"], got["graph.reverse"]
    assert rev["parent"] == cov["id"] and {r["trace"] for r in recs} == {root["id"]}
    assert rev["counts"] == {"elems": 128**2}
    assert len(got["cov.reverse"]) >= 2 and all(_inside(r, rev) for r in got["cov.reverse"])
    assert all(r["host_ns"][1] <= rev["host_ns"][0] for r in got["chol.reverse"] + got["solve.reverse"])
    assert T.active == 0


def test_the_graphs_reverse_on_another_thread():
    data = entry.mauna_loa_data(96, 32, torch.float64, "cpu")
    theta0, unflatten = P.init(entry.mauna_loa_spec(torch.float64, "cpu"))
    th = theta0.requires_grad_(True)
    with config.chol_backend("blocked"), T.recording():
        val = entry.mauna_loa_nlml(unflatten(th), data)
    worker = threading.Thread(target=lambda: torch.autograd.grad(val, th))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    got = _by_name(T.spans())
    (cov,), (rev,) = got["cov"], got["graph.reverse"]
    assert rev["parent"] == cov["id"] and rev["thread"] != cov["thread"]
    assert T.active == 0


def test_tracer_off_registers_no_hook_and_the_step_is_the_same(monkeypatch):
    hooks = []
    register = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook", lambda t, fn: hooks.append(t.shape) or register(t, fn))
    value_off, grad_off = _mauna_loa_step()
    assert hooks == [] and T.spans() == []
    with T.recording():
        value_on, grad_on = _mauna_loa_step()
    assert hooks == [(128, 128)]  # the covariance the graph returned
    assert float(value_on) == float(value_off) and torch.equal(grad_on, grad_off)


def _base_inverses_by_span(monkeypatch):
    """Span ids of the open span at each base-case inverse call (one call
    builds a whole stack of diagonal-block inverses)."""
    seen = []
    real = tbc._base_tri_inv

    def spy(L):
        seen.append(T.current()[0])
        return real(L)

    monkeypatch.setattr(tbc, "_base_tri_inv", spy)
    return seen


@pytest.mark.parametrize("width", ["wide", "vector"])
def test_blocked_solves_credit_the_blocks_each_route_applies(width, monkeypatch):
    """`blocked_solve`'s choice: a right-hand side of `_INV_MIN_COLS`
    columns applies the n/B diagonal blocks as GEMMs against one stack,
    built on the `solve` span and handed to the reverse rule; a vector
    takes TRSM on each, forward and reverse."""
    from stheno_tpu_torch.ops.chol import solve_lower

    n, wide = 2048, width == "wide"
    builds = _base_inverses_by_span(monkeypatch)
    rng = np.random.default_rng(1)
    G = rng.normal(size=(n, n))
    L = torch.linalg.cholesky(torch.as_tensor(G @ G.T / n + np.eye(n)))
    b = torch.as_tensor(rng.normal(size=(n, tbc._INV_MIN_COLS) if wide else n)).requires_grad_(True)
    for trans in (False, True):
        T.clear()
        builds.clear()
        with config.chol_backend("blocked"), T.recording():
            x = solve_lower(L, b, trans=trans)
            torch.autograd.grad(x.sum(), b)
        got = _by_name(T.spans())
        (fwd,), (rev,) = got["solve"], got["solve.reverse"]
        for span in (fwd, rev):
            want = {"solve.inv_blocks": n // 1024} if wide else {"solve.trsm_blocks": n // 1024}
            assert {k: v for k, v in span["counts"].items() if k.startswith("solve.")} == want
        assert builds == ([fwd["id"]] if wide else [])


def test_pseudo_point_products_build_their_stack_on_the_forward_span(monkeypatch):
    """`vfe_products` forward and backward: `vfe.fused` once, the stack
    built once on the `solve` span (`blocked_solve`), and handed to the
    reverse rule's two substitutions (P = L⁻ᵀS' and w = L⁻ᵀā), which build
    none."""
    from stheno_tpu_torch.ops.chol import vfe_products

    m, n = 512, max(96, tbc._INV_MIN_COLS)
    builds = _base_inverses_by_span(monkeypatch)
    rng = np.random.default_rng(2)
    G = rng.normal(size=(m, m))
    L = torch.linalg.cholesky(torch.as_tensor(G @ G.T / m + np.eye(m))).requires_grad_(True)
    Kt = torch.as_tensor(rng.normal(size=(m, n))).requires_grad_(True)
    b = torch.as_tensor(rng.normal(size=n)).requires_grad_(True)
    with config.chol_backend("blocked"), T.recording():
        Bp, a, t = vfe_products(L, Kt, b)
        torch.autograd.grad(Bp.sum() + a.sum() + t, (L, Kt, b))
    got = _by_name(T.spans())
    (fwd,), (rev,) = got["solve"], got["solve.reverse"]
    assert rev["counts"]["vfe.fused"] == 1 and "vfe.fused" not in fwd["counts"]
    assert builds == [fwd["id"]]
    assert fwd["counts"]["solve.inv_blocks"] == 1 and rev["counts"]["solve.inv_blocks"] == 2
    assert "solve.trsm_blocks" not in fwd["counts"] and "solve.trsm_blocks" not in rev["counts"]


@pytest.mark.parametrize("mode", ["iter", "rec"])
def test_reverse_sweeps_solve_against_the_saved_panel_inverses(mode, monkeypatch):
    """The factor's reverse rule solves K̄21 = L̄21 L11⁻¹ through
    `blocked_solve` against views of the forward's saved panel inverses
    (`_stack_view`): `chol.reverse` credits the diagonal blocks it applied
    (`solve.inv_blocks`), none by TRSM, and builds no stack of its own."""
    from stheno_tpu_torch.ops.chol import cholesky_psd

    n = 2048
    builds = _base_inverses_by_span(monkeypatch)
    rng = np.random.default_rng(3)
    G = rng.normal(size=(n, n))
    A = torch.as_tensor(G @ G.T / n + np.eye(n)).requires_grad_(True)
    with config.chol_backend("blocked"), config.bwd_params(block=512, mode=mode), T.recording():
        cholesky_psd(A).sum().backward()
    got = _by_name(T.spans())
    (factor,), (rev,) = got["chol.factor"], got["chol.reverse"]
    assert rev["counts"].get("solve.inv_blocks", 0) > 0 and "solve.trsm_blocks" not in rev["counts"]
    assert builds and set(builds) == {factor["id"]}


def test_a_trace_takes_its_own_spans_out_of_the_store(tmp_path):
    with T.recording(), T.span("before"):
        pass
    with T.Trace("region") as tr:
        with T.span("inside"):
            pass
    with T.recording(), T.span("after"):
        pass
    assert [r["name"] for r in tr.spans] == ["inside"]
    assert [r["name"] for r in T.spans()] == ["before", "after"]


def test_exported_events_sit_on_the_files_clock():
    recs = [{"name": "logpdf", "id": 1, "parent": None, "trace": 1, "thread": 7,
             "host_ns": (5_000_000, 9_000_000), "device_ns": (6_000_000, 9_500_000),
             "counts": {"elems": 4}},
            {"name": "cov", "id": 2, "parent": 1, "trace": 1, "thread": 7,
             "host_ns": (5_100_000, 5_200_000), "device_ns": None, "counts": {}}]
    events = T.chrome_events(recs, base_ns=1_000_000)
    spans = [e for e in events if e["ph"] == "X"]
    host = [e for e in spans if e["pid"] == T.HOST_PID]
    device = [e for e in spans if e["pid"] == T.DEVICE_PID]
    assert [(e["name"], e["ts"], e["dur"], e["tid"]) for e in host] == [
        ("logpdf", 4000.0, 4000.0, 7), ("cov", 4100.0, 100.0, 7)]
    assert [(e["name"], e["ts"], e["dur"]) for e in device] == [("logpdf", 5000.0, 3500.0)]
    assert host[0]["args"] == {"id": 1, "parent": None, "trace": 1, "elems": 4}
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert {"program (host)", "program (device)", "thread 7"} <= names
    json.dumps(events)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


#: How far a kernel may lie outside its span's device interval.
SLACK_NS = 50_000


@pytest.mark.gpu
def test_device_intervals_hold_the_profilers_kernels(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    x = torch.linspace(-5.0, 5.0, 8192, device=cuda_device)[:, None]
    v = torch.tensor(1.5, device=cuda_device)
    tkm.kernelmatrix_forward(x, None, "se", v)  # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            torch.cuda._sleep(200_000)  # work queued before the span
            with T.span("km"):
                tkm.kernelmatrix_forward(x, None, "se", v)
        torch.cuda.synchronize()
    recs = T.spans()
    events = list(prof.profiler.kineto_results.events())
    kernels = [e for e in events if "km_kernel" in e.name()]
    launches = {e.correlation_id(): e for e in events if "LaunchKernel" in e.name()}
    assert len(recs) == len(kernels) == 5
    for rec, k in zip(recs, sorted(kernels, key=lambda e: e.start_ns())):
        d0, d1 = rec["device_ns"]
        h0, h1 = rec["host_ns"]
        assert d0 - SLACK_NS <= k.start_ns() <= k.end_ns() <= d1 + SLACK_NS, (d0, d1, k.start_ns(), k.end_ns())
        launch = launches[k.correlation_id()]
        assert h0 <= launch.start_ns() <= h1, (h0, h1, launch.start_ns())


@pytest.mark.gpu
def test_spans_leave_the_device_launches_alone(cuda_device, monkeypatch):
    """The same kernels run in a flagship step with spans on (a profiler
    records) and off: a span's timing events are no device operations."""
    from torch.profiler import ProfilerActivity, profile

    x, y, theta = _flagship(4096, torch.float32, cuda_device)

    def kernels():
        _step(x, y, theta)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            val, leaves = _step(x, y, theta)
            torch.autograd.grad(val, list(leaves.values()))
            torch.cuda.synchronize()
        return sorted(e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)

    on = kernels()
    assert {r["name"] for r in T.spans()} >= {"logpdf", "chol.factor", "chol.reverse"}
    T.clear()
    monkeypatch.setattr(T, "_profiler", types.SimpleNamespace(_is_profiler_enabled=False))
    off = kernels()
    assert T.spans() == []
    assert on == off

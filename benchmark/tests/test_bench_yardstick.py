"""The frozen yardstick on synthetic inputs: the trace's reduction, the
peaks and least times, the problem's counts, the metrics' readers and the
comparisons."""

import math

import pytest
import torch
from harness import compare, roofline
from harness import trace as tr
from harness.registry import Registry, load_module

from conftest import BENCH, ROOT

REG = Registry(ROOT)


def test_busy_is_the_union_of_intervals():
    device = [("ampere_sgemm_128x64_nn", 0, 10), ("km_kernel<float>", 5, 12),
              ("trsm_left_kernel", 20, 25), ("Memcpy DtoH (Device -> Pageable)", 30, 31)]
    spans = [("logpdf", 0, 18), ("grad", 18, 28), ("adam", 28, 29)]
    s = tr.summarize(device, spans, (0, 40))
    assert s["window_s"] == pytest.approx(40e-6)
    assert s["busy_s"] == pytest.approx((12 + 5 + 1) * 1e-6)
    assert s["kernels"] == 3
    assert s["by_kind_s"]["gemm"] == pytest.approx(10e-6)
    assert s["by_kind_s"]["kernelmatrix"] == pytest.approx(7e-6)
    assert s["by_kind_s"]["trsm"] == pytest.approx(5e-6)
    # gaps: 12-20 under logpdf, 25-30 under grad and adam (innermost at 25: grad), 31-40 outside
    gaps = dict(s["idle_gaps"])
    assert gaps["logpdf"] == pytest.approx(8e-6)
    assert gaps["grad"] == pytest.approx(5e-6)
    assert gaps["outside spans"] == pytest.approx(9e-6)
    assert s["device_ops"][0][0] == "ampere_sgemm_128x64_nn"


def test_trace_is_clipped_to_its_window_and_must_hold_the_device():
    device = [("gemm", -5, 5), ("gemm", 8, 9), ("gemm", 50, 60)]
    s = tr.summarize(device, [], (0, 10))
    assert s["busy_s"] == pytest.approx(6e-6)
    with pytest.raises(ValueError):
        tr.summarize([("gemm", 50, 60)], [], (0, 10))


def test_kinds_follow_the_frozen_groups():
    assert tr.kind_of("void km_vjp_kernel<float, 0, 1>") == "kernelmatrix_vjp"
    assert tr.kind_of("void km_kernel<float, 2, 1, 0>") == "kernelmatrix"
    assert tr.kind_of("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n") == "gemm"
    assert tr.kind_of("void chol_block_kernel(float const*)") == "chol_block"
    assert tr.kind_of("something else") == "other"


def test_least_times():
    t, by = roofline.bound_s(3.35e12, 1.0)
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = roofline.bound_s(0, 67e12)
    assert (t, by) == (pytest.approx(1.0), "operations")
    n = 16384
    # the 16384² same-input forward writes 1 GiB: 0.3205 ms, PERF.md's bound
    assert roofline.km_forward_least_s(n, n, 1, True, 4) * 1e3 == pytest.approx(0.3205, abs=1e-4)
    assert roofline.km_vjp_least_s(n, n, 1, True, 4) * 1e3 == pytest.approx(0.3206, abs=1e-4)
    assert roofline.km_forward_least_s(8, 8, 1, True, 4, batch=3) == \
        pytest.approx(3 * roofline.km_forward_least_s(8, 8, 1, True, 4))


def test_counts():
    flag = load_module(BENCH / "counts" / "flagship.py", "counts")
    pp = load_module(BENCH / "counts" / "pseudo_points.py", "counts")
    cfg = REG.config("flagship16k")
    n = 16384
    assert flag.flops(cfg, "fit", {}) == pytest.approx(n**3)
    assert flag.flops(cfg, "query", {"points": 4096}) == pytest.approx(n * n * 4096 + 4 * n * 4096)
    assert flag.flops(cfg, "predict", {"points": 1024}) == \
        pytest.approx(n**3 / 3 + 2 * n * n + n * n * 1024 + 4 * n * 1024)
    assert pp.flops(REG.config("vfe131k"), "fit", {}) == pytest.approx(3 * 4096**2 * 131072)
    assert pp.flops(REG.config("vfe131k"), "query", {}) is None


def _run(kind):
    trace = {"window_s": 0.5, "busy_s": 0.45, "kernels": 3000, "units": 3,
             "by_kind_s": {"gemm": 0.3, "trsm": 0.03, "kernelmatrix": 0.002, "kernelmatrix_vjp": 0.004},
             "km_least_s": {"forward": 0.0018, "vjp": 0.002}}
    window = {"units": 100, "window_s": 20.0}
    if kind != "fit":
        window.update(latencies_s=[0.01 * (1 + i / 100) for i in range(100)], points_per_unit=4096)
    return {"kind": kind, "setup_s": 12.5, "window": window, "trace": trace, "unit_flops": 2.68e12}


@pytest.mark.parametrize("kind", ["fit", "query"])
def test_readers(kind):
    values = {m["name"]: REG.reader(m["name"]).read(_run(kind))
              for m in REG.spec["end_to_end"] + REG.spec["per_layer"]}
    fit = kind == "fit"
    assert values["setup_s"] == 12.5
    assert (values["step_ms"] == pytest.approx(200.0)) if fit else values["step_ms"] is None
    mfu = 2.68e12 / 0.2 / 67e12 * 100
    assert values["step_mfu" if fit else "request_mfu"] == pytest.approx(mfu)
    assert values["request_mfu" if fit else "step_mfu"] is None
    assert values["idle_share.train" if fit else "idle_share.request"] == pytest.approx(10.0)
    assert values["km_roofline.train" if fit else "km_roofline.request"] == pytest.approx(90.0)
    assert values["launches_per_step" if fit else "launches_per_request"] == pytest.approx(1000.0)
    if fit:
        assert values["gemm_ms_per_step"] == pytest.approx(100.0)
        assert values["km_vjp_roofline.train"] == pytest.approx(50.0)
    else:
        assert values["solve_ms_per_request"] == pytest.approx(110.0)
        assert values["points_per_s"] == pytest.approx(100 * 4096 / 20.0)
        assert values["request_p95_ms"] == pytest.approx(10 * (1 + 94.05 / 100))


def test_a_reader_with_nothing_to_read_returns_nothing():
    run = _run("fit")
    run["trace"]["by_kind_s"].pop("kernelmatrix")
    assert REG.reader("km_roofline.train").read(run) is None
    run["trace"] = None
    assert REG.reader("km_roofline.train").read(run) is None
    assert REG.reader("idle_share.train").read(run) is None
    run["window"]["units"] = 0
    assert REG.reader("step_mfu").read(run) is None


def test_comparisons():
    leaves = (("a", 1), ("b", 1), ("z", 3))
    ref = torch.tensor([1.0, 0.0, 3.0, 0.0, 4.0])  # norms 1, 0, 5: median 1
    prog = torch.tensor([1.1, 1e-3, 3.0, 0.0, 4.0])
    assert compare.worst_gap_of_norms(prog, ref, leaves) == pytest.approx(0.1)
    assert compare.worst_difference(prog, ref, leaves) == pytest.approx(0.1)
    assert compare.moved_leaves(ref, leaves) == [True, False, True]
    assert compare.worst_gap_of_norms(prog, ref, leaves, keep=[False, True, True]) == pytest.approx(1e-3)
    assert compare.relative_gap(1.01, 1.0) == pytest.approx(0.01)
    assert compare.verdict([{"value": 0.1, "limit": 0.2}])
    assert not compare.verdict([{"value": math.nan, "limit": 0.2}])
    assert not compare.verdict([{"value": 0.3, "limit": 0.2}])


def test_kernel1_launches_are_held_to_the_ports_counts(monkeypatch):
    """Kernel 1's shares read the port's launch counters: a counter the
    program lacks is an error, not a share left out; a trace that lost
    counted launches is incomplete; one with launches nobody counted is an
    error."""
    from harness import runner
    from stheno_tpu_torch.cuda import kernelmatrix as km

    class Counter:
        def __init__(self, total):
            self.total, self.by_shape = total, {}

        def reset(self):
            self.total = 0

    counters = (Counter(2), Counter(0), Counter(1))
    fwd = ("void km_kernel<float, 0, 1>(...)", 0.0, 1.0)
    vjp = ("void km_vjp_kernel<float, 0, 1>(...)", 1.0, 2.0)
    other = ("sgemm_256x128_nn", 2.0, 3.0)
    assert runner._launches_seen([fwd, fwd, vjp, other], counters)
    assert not runner._launches_seen([fwd, vjp, other], counters)
    with pytest.raises(RuntimeError, match="counted"):
        runner._launches_seen([fwd, fwd, fwd, vjp], counters)
    with pytest.raises(RuntimeError, match="counts none"):
        runner._launches_seen([fwd], None)
    assert runner._launches_seen([other], None)
    assert len(runner._km_counters()) == 3
    monkeypatch.delattr(km, "VJP_LAUNCHES")
    with pytest.raises(RuntimeError, match="VJP_LAUNCHES"):
        runner._km_counters()

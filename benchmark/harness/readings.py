"""What the metrics' readers share: a run's unit time and per-unit
quantities.  A run is the dict `runner.run_cell` returns beside its result:
`kind` (the traffic's), `setup_s`, `window` (`units`, `window_s`, and for
requests `latencies_s` and `points_per_unit`), `unit_flops` (the problem's
work a unit, from `counts/`) and, in a traced run, `trace` (the summary of
`harness/trace.py`, with `units` and, where the port counts kernel 1's
launches, `km_least_s`)."""

from __future__ import annotations

FIT = ("fit",)
REQUESTS = ("query", "predict")


def unit_s(run):
    """Seconds a unit (a step or a request) over the untraced window: all
    the window's time over all its units."""
    w = run["window"]
    return w["window_s"] / w["units"] if w["units"] else None


def traced_per_unit(run, seconds):
    tr = run.get("trace")
    if not tr or seconds is None:
        return None
    return seconds / tr["units"]


def kind_seconds(run, *kinds):
    """Device seconds of the traced window in the given kinds, or None where
    none of them ran."""
    tr = run.get("trace")
    if not tr:
        return None
    found = [tr["by_kind_s"][k] for k in kinds if k in tr["by_kind_s"]]
    return sum(found) if found else None


def mfu(run, kinds):
    """The problem's work a unit over the unit's time in the untraced window,
    as a share (%) of the float32 peak: the whole unit's share, idle time
    included, on the host's clock.  (The traced window is slowed by the
    profiler, so a unit's time read there would understate the share.)"""
    from harness.roofline import FP32_FLOP_PER_S

    if run["kind"] not in kinds or not run.get("unit_flops"):
        return None
    t = unit_s(run)
    return None if not t else run["unit_flops"] / t / FP32_FLOP_PER_S * 100.0


def km_roofline(run, kinds, which, kind_name):
    """Kernel 1's least time over its device time in the traced window (%)."""
    if run["kind"] not in kinds:
        return None
    tr = run.get("trace") or {}
    least = (tr.get("km_least_s") or {}).get(which)
    spent = tr.get("by_kind_s", {}).get(kind_name)
    if not least or not spent:
        return None
    return least / spent * 100.0


def idle_share(run, kinds):
    tr = run.get("trace")
    if run["kind"] not in kinds or not tr:
        return None
    return (1.0 - tr["busy_s"] / tr["window_s"]) * 100.0


def launches(run, kinds):
    tr = run.get("trace")
    if run["kind"] not in kinds or not tr:
        return None
    return tr["kernels"] / tr["units"]

"""One run of one cell: set-up, the measured window, with `trace` a profiled
sub-window after it, then the comparison with the plain reference.

The flow is the same for every cell; what differs sits in the files the
registry finds by name (the traffic's driver, the configuration's adapter,
counts and reference, the cell's limits and the metrics' readers).

1. Set-up: the driver makes the inputs from the seed on the device and
   warms up every shape its traffic uses through the timed call itself.
   `setup_s` runs from the process's start (`t_start`) to here.
2. The window: the driver runs its traffic for `seconds`, tracing off.
   The profiler is not started before the window closes: once started, it
   slows every later launch on the host, so a traced run's window times
   the same work as an untraced run's.
3. With tracing, the profiler's own start-up (a unit under each kind of
   pass), then `trace_units` more units under torch.profiler, twice (see
   `traced_window`).
4. The device's peak memory is read, the program's state is dropped, and
   the driver judges what the timed path produced against the reference.
"""

from __future__ import annotations

import contextlib
import gc
import random
import sys
import time
from pathlib import Path

import torch
from harness import compare
from harness import roofline
from harness import trace as tracing
from harness.registry import Registry

#: Host spans carry this prefix in the profiler's timeline.
SPAN_PREFIX = "bench."
#: The traced run's profiler trace, under the checkout.
TRACE_DIR = "benchmark/traces"
ITEMSIZE = {"float32": 4, "float64": 8}
#: The traced window starts after a marker kernel of this name
#: (`torch.cuda._sleep`), of this many clock cycles.
MARK_KERNEL, MARK_CYCLES = "spin_kernel", 1000
#: Device-only passes tried before a traced run that keeps losing kernel-1
#: launches fails.
TRACE_TRIES = 3


class Spans:
    """Host spans from the harness's own files, around its calls into the
    program.  They are recorded in the profiler's timeline while a traced
    window is open, and cost nothing otherwise."""

    def __init__(self):
        self.on = False

    def __call__(self, name):
        if self.on:
            return torch.profiler.record_function(SPAN_PREFIX + name)
        return contextlib.nullcontext()


class Context:
    """Everything a driver needs for one run."""

    def __init__(self, reg, workload, seed, device, overrides=None):
        overrides = overrides or {}
        self.reg = reg
        self.cell = reg.cell(workload)
        self.name = workload
        self.cfg = {**reg.config(self.cell["config"]), **overrides.get("config", {})}
        self.traffic = {**reg.traffic(self.cell["traffic"]), **overrides.get("traffic", {})}
        self.limits = reg.limits(workload)
        self.kind = self.traffic["kind"]
        self.driver = reg.driver(self.kind)
        self.programme = reg.programme(self.cfg["programme"])
        self.counts = reg.counts(self.cfg["programme"])
        self.reference = reg.reference(self.cell["config"])
        self.seed = seed
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.rng = random.Random(seed)
        self.spans = Spans()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@contextlib.contextmanager
def precision_scope(gemm_precision, control=False):
    """The program's numerics as the configuration states them: the port's
    `config.gemm_precision(gemm_precision)` route with torch's TF32 switch
    off.  `control` is the control of `correct`, the nearest precision
    below: the port's own TF32 route (`config.gemm_precision('default')`)
    with torch's TF32 switch on for every other float32 product."""
    from stheno_tpu_torch import config

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control
    try:
        with config.gemm_precision("default" if control else gemm_precision):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


#: The port's launch counters of kernel 1 (`cuda/kernelmatrix.py`), each
#: with `total`, `by_shape` and `reset`.
KM_COUNTERS = ("LAUNCHES", "BATCHED_LAUNCHES", "VJP_LAUNCHES")


def _km_counters():
    """The port's launch counters of kernel 1, or None where the program
    holds no kernel 1 at all.  Where it does, a counter it lacks is an
    error: kernel 1's shares are not left out for want of a reading."""
    try:
        from stheno_tpu_torch.cuda import kernelmatrix as km
    except ImportError:
        return None
    counters = tuple(getattr(km, name, None) for name in KM_COUNTERS)
    missing = [name for name, c in zip(KM_COUNTERS, counters)
               if not all(hasattr(c, a) for a in ("total", "by_shape", "reset"))]
    if missing:
        raise RuntimeError(f"kernel 1's launch counters are missing from {km.__name__}: {', '.join(missing)}")
    return counters


def _km_least(counters, itemsize):
    """Least seconds of kernel 1's forward and VJP launches counted."""
    single, batched, vjp = counters
    fwd = sum(c * roofline.km_forward_least_s(n, m, d, same, itemsize)
              for (n, m, d, same), c in single.by_shape.items())
    fwd += sum(k * roofline.km_forward_least_s(n, m, d, same, itemsize, batch=c)
               for (c, n, m, d, same), k in batched.by_shape.items())
    back = sum(k * roofline.km_vjp_least_s(n, m, d, same, itemsize, batch=c)
               for (c, n, m, d, same), k in vjp.by_shape.items())
    return fwd, back


def _events(prof):
    """(device operations, host spans, the window span) of a trace.  A
    span's shadow on the device's timeline is no operation and is left out."""
    device, spans, window = [], [], None
    for e in prof.events():
        item = (e.name, e.time_range.start, e.time_range.end)
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if not e.name.startswith(SPAN_PREFIX):
            if on_device:
                device.append(item)
        elif on_device:
            continue
        elif e.name == SPAN_PREFIX + "window":
            window = item[1:]
        else:
            spans.append((e.name[len(SPAN_PREFIX):], item[1], item[2]))
    return device, spans, window


def _device_pass(ctx, st, units, counters):
    """`units` units under torch.profiler recording the device alone.

    A profiler can lose the first operations after it starts, so one unit
    runs first inside the trace, then a marker kernel (`torch.cuda._sleep`,
    whose kernel is named `spin_kernel`); the window is what follows the
    marker, and its length is the host clock's from the marker to the
    closing synchronise.  Returns (device operations in the window, window)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ctx.driver.unit(ctx, st)
        ctx.sync()
        torch.cuda._sleep(MARK_CYCLES)
        ctx.sync()
        if counters:
            for c in counters:
                c.reset()
        t0 = time.perf_counter()
        for _ in range(units):
            ctx.driver.unit(ctx, st)
        ctx.sync()
        host_us = (time.perf_counter() - t0) * 1e6
    device, _, _ = _events(prof)
    marks = [e for _, _, e in (d for d in device if MARK_KERNEL in d[0])]
    if not marks:
        raise RuntimeError("the device trace holds no marker kernel")
    w0 = max(marks)
    return [d for d in device if d[1] >= w0], (w0, w0 + host_us)


def _kernel1_in_trace(device):
    """Kernel 1's forward and VJP launches in a device trace, by name."""
    names = [tracing.kind_of(name) for name, _, _ in device]
    return names.count("kernelmatrix"), names.count("kernelmatrix_vjp")


def _launches_seen(device, counters):
    """Whether the trace holds kernel 1's launches that the port counted:
    True where it holds all of them, False where it lost some.  A trace
    that holds launches the port did not count, or kernel-1 launches where
    the program has no counters, is an error: the counts of least time
    would not cover the kernel's device time."""
    fwd, vjp = _kernel1_in_trace(device)
    if counters is None:
        if fwd or vjp:
            raise RuntimeError(f"the trace holds {fwd} + {vjp} kernel-1 launches and the program counts none")
        return True
    single, batched, vjp_c = counters
    counted = single.total + batched.total, vjp_c.total
    if fwd > counted[0] or vjp > counted[1]:
        raise RuntimeError(f"the trace holds kernel-1 launches (forward, VJP) {(fwd, vjp)} "
                           f"against {counted} that the port counted")
    return (fwd, vjp) == counted


def traced_window(ctx, st, root):
    """The traced sub-window, twice `trace_units` units.

    First under torch.profiler recording the device alone, which costs the
    host next to nothing: the metrics' summary (busy time, kernels, time by
    kind, kernel 1's launches against the port's own counts).  A pass whose
    trace lacks kernel-1 launches the port counted lost events and is run
    again, up to `TRACE_TRIES` times; after that the run fails.  Then again with the host's operations and the harness's spans
    recorded, which slows the host: that trace names the idle gaps by the
    span active when each began (`idle_gaps`), and is the one written to
    `benchmark/traces/<cell>.json`."""
    from torch.profiler import ProfilerActivity, profile

    units = ctx.traffic["trace_units"]
    counters = _km_counters()
    for _ in range(TRACE_TRIES):
        device, window = _device_pass(ctx, st, units, counters)
        complete = _launches_seen(device, counters)
        if complete:
            break
    if not complete:
        raise RuntimeError(f"{TRACE_TRIES} device traces in a row lost kernel-1 launches that the port counted")
    summary = tracing.summarize(device, [], window)
    summary["units"] = units
    if counters:
        fwd, back = _km_least(counters, ITEMSIZE[ctx.cfg["dtype"]])
        summary["km_least_s"] = {"forward": fwd, "vjp": back}

    ctx.spans.on = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(SPAN_PREFIX + "window"):
                for _ in range(units):
                    ctx.driver.unit(ctx, st)
                ctx.sync()
    finally:
        ctx.spans.on = False
    device, spans, window = _events(prof)
    if window is None:
        raise RuntimeError("the annotated trace holds no window span")
    named = tracing.summarize(device, spans, window)
    summary["idle_gaps"] = named["idle_gaps"]
    out = Path(root) / TRACE_DIR
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"{ctx.name}.json"))
    return summary


def _profiler_warmup(ctx, st):
    from torch.profiler import ProfilerActivity, profile

    for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=activities):
            ctx.driver.unit(ctx, st)
            ctx.sync()
            torch.cuda._sleep(MARK_CYCLES)
            ctx.sync()


def read_metrics(ctx, run, traced):
    """Each metric of the run by its own reader; one that finds nothing to
    read is left out."""
    out = {}
    for m in ctx.reg.metrics(ctx.name, traced):
        value = ctx.reg.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def phase(name, t_start):
    print(f"phase {name} {time.perf_counter() - t_start:.3f} s", file=sys.stderr, flush=True)


def run_cell(root, workload, seed, seconds, trace, device, t_start, overrides=None, control=False):
    """One run.  Returns `(result, run, ctx)`: the result line's keys
    (without `device`, which the caller adds), what the metrics are read
    from, and the run's context.  Each phase's end goes to standard error."""
    reg = Registry(root)
    ctx = Context(reg, workload, seed, device, overrides)
    phase("start", t_start)
    with precision_scope(ctx.cfg["gemm_precision"], control):
        st = ctx.driver.setup(ctx)
        ctx.sync()
        setup_s = time.perf_counter() - t_start
        phase("setup", t_start)
        window = ctx.driver.window(ctx, st, seconds)
        phase("window", t_start)
        summary = None
        if trace:
            _profiler_warmup(ctx, st)
            summary = traced_window(ctx, st, root)
            phase("trace", t_start)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else None
    judged = ctx.driver.collect(ctx, st)
    del st
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = ctx.driver.check(ctx, judged)
    phase("reference", t_start)
    correct = compare.verdict(checks) and judged["attempted"] > 0 and judged["failed"] == 0
    run = {"kind": ctx.kind, "setup_s": setup_s, "window": window, "trace": summary,
           "unit_flops": ctx.counts.flops(ctx.cfg, ctx.kind, ctx.traffic)}
    result = {"correct": correct, "attempted": judged["attempted"], "failed": judged["failed"],
              "checks": checks, "memory_peak_bytes": peak}
    return result, run, ctx

"""Observability: per-iteration scalar logging, and the program's tracer
(spans, counts and launch counters) with its exporter into a profiler trace
(the scalar logging is the counterpart of `stheno_tpu/utils/logging.py`).

The reference streams scalars out of a compiled loop with
`jax.debug.callback`.  The port's loops run on the host, so `log_scalars`
calls its sink directly; reading a tensor on the card waits for it, so log
every N steps rather than every step.

The tracer
----------

`span(name)` marks a layer of the program: the public verbs of
`finite_gp.py`, `entry.predict`, the covariance blocks asked of the process
graph, the factor, the substitutions and their reverse rules
(`docs/internals.md` lists them).  It is on

- inside `recording()`, on the thread that opened it, and
- on every thread while a torch profiler records
  (`torch.autograd.profiler._is_profiler_enabled`),

and off otherwise, where it returns one shared null context after reading
two flags, and records nothing, reads no clock and makes no CUDA event.

An open span keeps a record in memory until `spans()` reads it (no I/O on
the hot path): its name, id, parent (the innermost open span on its thread,
or the span that a reverse rule names), trace id (the outermost span of the
call, so every span of one call into the program shares it), thread, host
start and end on `time.time_ns()` (the clock the profiler stamps its events
with), and its counts.  While CUDA is initialised and the current stream is
not capturing a graph, a span also records a pair of timing events on the
current stream; they give its device interval, from the moment the device
finished the work queued before the span to the moment it finished the
span's work.  The events are resolved only when the records are read
(`spans()`, or `Trace` on exit), onto the host clock through one anchor a
device taken then (a synchronise, then `time.time_ns()` beside an event
recorded at once): nothing waits for the device while spans record.  An
interval's length is exact to the events' resolution (about 0.5 µs); its
place on the host clock drifts with the time from the span to the read.
The store keeps the newest `MAX_RECORDS` closed spans, so a profiler left
recording over a long run holds a bounded number of records and events.
A span never calls `record_function`: that would leave a shadow on the
device's timeline.

`on_reverse(t, name, parent)` marks a layer whose reverse has no rule of
its own to hold a span (the process graph's algebra, which autograd
differentiates op by op): from the moment a backward pass has `t`'s
cotangent to the pass's end.

`credit(key, n)` adds `n` to a count of the innermost open span on this
thread (`panels`, `gemm_flops`, `elems`), and `LaunchCounter.add` credits it
with one launch of its kernel (`launches.<kernel>`).  Callers test the
module's `active` (spans open now, on any thread) first, so that a count
costs one branch while tracing is off.

`Trace` is the operator's exporter: the torch profiler around a region,
with the program's spans written into the same chrome trace; it takes the
spans of its region out of the store.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import sys
import threading
import time
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _profiler


def _default_sink(tag, step, values):
    parts = " ".join(f"{k}={float(v):.5g}" for k, v in values.items())
    print(f"[{tag}] step {int(step):>6d}  {parts}", file=sys.stderr, flush=True)


def log_scalars(tag: str, step, every: int = 1, sink=None, **values):
    """Emit named scalars every `every` steps:

        log_scalars("fit", step=i, every=50, loss=loss, lr=lr)
    """
    if int(step) % every == 0:
        (sink or _default_sink)(tag, step, values)


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

#: Spans open now, over every thread.  Zero while tracing is off: a count
#: tests it before anything else.
active = 0
#: `recording()` blocks open now, over every thread.
_recording = 0
_lock = threading.Lock()
_tls = threading.local()
_ids = itertools.count(1)
#: How many closed spans the store keeps; the oldest go first.
MAX_RECORDS = 16384
#: Closed spans not yet cleared, in the order they closed.
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
#: device index -> timing events already read, to be recorded again
#: (making one costs the host more than recording it)
_free: dict = {}


def _stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _thread_id():
    """The system's id of this thread, asked of the system once a thread (a
    system call, which costs tens of µs on some hosts)."""
    try:
        return _tls.tid
    except AttributeError:
        _tls.tid = threading.get_native_id()
        return _tls.tid


def _on_here():
    """Whether a span without a named parent records on this thread."""
    return (_profiler._is_profiler_enabled or getattr(_tls, "depth", 0) > 0
            or bool(getattr(_tls, "stack", None)))


class _Null:
    """The context every span is while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _anchor(dev):
    """The host clock of a device's timing events, as `(event, host ns)`: a
    synchronise, then an event recorded at once, beside `time.time_ns()`."""
    torch.cuda.synchronize(dev)
    ev = _record_event(dev, torch.cuda.current_stream(dev))
    host = time.time_ns()
    torch.cuda.synchronize(dev)
    return ev, host


def _record_event(dev, stream):
    try:
        ev = _free[dev].pop()
    except (KeyError, IndexError):
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _device():
    """The current CUDA device where a span's events may go, or None: CUDA
    not initialised, or the current stream capturing a graph."""
    if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_device()


class _Span:
    __slots__ = ("name", "id", "parent", "trace", "thread", "t0", "t1", "counts",
                 "dev", "stream", "ev0", "ev1", "d0", "d1", "_named")

    def __init__(self, name, parent):
        self.name = name
        self._named = parent

    def __enter__(self):
        stack = _stack()
        self.open(self._named or (stack[-1].handle() if stack else None))
        stack.append(self)
        return self

    def open(self, parent):
        """Start the span under `parent`, on no thread's stack."""
        global active
        self.id = next(_ids)
        self.parent, self.trace = (None, self.id) if parent is None else parent
        self.thread = _thread_id()
        self.counts = {}
        self.d0 = self.d1 = self.ev0 = self.ev1 = None
        self.dev = _device()
        self.t0 = time.time_ns()
        if self.dev is not None:
            # the device given: without it torch looks the device up anew
            self.stream = torch.cuda.current_stream(self.dev)
            self.ev0 = _record_event(self.dev, self.stream)
        with _lock:
            active += 1
        return self

    def __exit__(self, *exc):
        self.close()
        _stack().pop()
        return False

    def close(self):
        """End the span, on whichever thread."""
        global active
        if self.ev0 is not None:
            self.ev1 = _record_event(self.dev, self.stream)
        self.t1 = time.time_ns()
        with _lock:
            active -= 1
            _records.append(self)

    def handle(self):
        """(id, trace id): what a reverse rule keeps to name its parent."""
        return self.id, self.trace

    def resolve(self, anchors):
        """The device interval on the host clock (ns), through the anchor
        of its device in `anchors`; read once."""
        if self.ev1 is not None:
            anchor, host = anchors[self.dev]
            self.d0 = host - round(self.ev0.elapsed_time(anchor) * 1e6)
            self.d1 = self.d0 + round(self.ev0.elapsed_time(self.ev1) * 1e6)
            _free.setdefault(self.dev, []).extend((self.ev0, self.ev1))
            self.ev0 = self.ev1 = self.stream = None
        return self


def span(name, parent=None):
    """A span of the program named `name`, as a context manager.  `parent`
    is the `current()` of a forward pass, which its reverse rule names as
    its span's parent (autograd may run the rule on a thread of its own):
    such a span records whenever its forward's did."""
    if not (_recording or _profiler._is_profiler_enabled or parent is not None):
        return _NULL
    if parent is None and not _on_here():
        return _NULL
    return _Span(name, parent)


def current():
    """`(id, trace id)` of the innermost open span on this thread, or None
    (always None while tracing is off)."""
    if not active:
        return None
    stack = getattr(_tls, "stack", None)
    return stack[-1].handle() if stack else None


def credit(key, n):
    """Add `n` to the count `key` of the innermost open span on this thread
    (callers test `active` first)."""
    stack = getattr(_tls, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[key] = counts.get(key, 0) + n


def on_reverse(t, name, parent):
    """The reverse of what produced `t` as a span `name` under `parent`
    (the `current()` of its forward): it opens when a backward pass has
    `t`'s cotangent ready and closes when that pass ends, on whichever
    threads autograd runs the two, so the reverse rules that run in between
    lie inside it.  It is credited with the cotangent's entries (`elems`).
    It registers a tensor hook: call it only while spans record, on a
    tensor that requires grad."""

    def hook(t_bar):
        s = _Span(name, parent).open(parent)
        s.counts["elems"] = t_bar.numel()
        torch.autograd.Variable._execution_engine.queue_callback(s.close)

    t.register_hook(hook)


@contextmanager
def recording():
    """Spans on for this thread (and for the reverse rules of what it
    records, wherever autograd runs them).  Nests; other threads are not
    switched."""
    global _recording
    with _lock:
        _recording += 1
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1
        with _lock:
            _recording -= 1


def _read(recs):
    """The records `recs` as `spans()` gives them, their events resolved
    through one new anchor a device."""
    anchors = {dev: _anchor(dev) for dev in {r.dev for r in recs if r.ev1 is not None}}
    with _lock:  # one reader at a time resolves a span and returns its events
        for r in recs:
            r.resolve(anchors)
        for dev, (ev, _) in anchors.items():
            _free.setdefault(dev, []).append(ev)
    out = []
    for r in sorted(recs, key=lambda r: (r.t0, r.id)):
        out.append({"name": r.name, "id": r.id, "parent": r.parent, "trace": r.trace,
                    "thread": r.thread, "host_ns": (r.t0, r.t1),
                    "device_ns": None if r.d0 is None else (r.d0, r.d1), "counts": dict(r.counts)})
    return out


def spans():
    """Every closed span the store holds (since the last `clear()`, the
    newest `MAX_RECORDS`), oldest start first, as dicts: `name`, `id`,
    `parent`, `trace`, `thread`, `host_ns` (start, end), `device_ns`
    (start, end on the host clock, or None where the span recorded no
    events) and `counts`.  Waits for the device where a span's events are
    not resolved yet."""
    return _read(list(_records))


def _take(region):
    """The closed spans that began at or after `region[0]` and ended by
    `region[1]` (host ns), read and taken out of the store."""
    t0, t1 = region
    mine, keep = [], []
    with _lock:
        for r in _records:
            (mine if t0 <= r.t0 and r.t1 <= t1 else keep).append(r)
        _records.clear()
        _records.extend(keep)
    return _read(mine)


def clear():
    """Forget every closed span, and the timing events kept for reuse."""
    _records.clear()
    _free.clear()


# ---------------------------------------------------------------------------
# Launch counters
# ---------------------------------------------------------------------------


class LaunchCounter:
    """Counts the launches of one kernel, in total and by launch shape;
    while a span is open, each launch is also credited to the innermost one
    on this thread (`launches.<name>`)."""

    def __init__(self, name: str):
        self.name = name
        self.key = f"launches.{name}"
        self.total = 0
        self.by_shape: dict[tuple, int] = {}

    def add(self, shape: tuple) -> None:
        self.total += 1
        self.by_shape[shape] = self.by_shape.get(shape, 0) + 1
        if active:
            credit(self.key, 1)

    def reset(self) -> None:
        self.total = 0
        self.by_shape = {}


# ---------------------------------------------------------------------------
# The exporter
# ---------------------------------------------------------------------------

#: Process ids of the program's tracks in an exported trace, apart from the
#: profiler's own (its processes are numbered by the system).
HOST_PID, DEVICE_PID = 1_000_000_001, 1_000_000_002


def chrome_events(records, base_ns=0):
    """The spans `records` (from `spans()`) as chrome-trace events, `ts` in
    µs after `base_ns`: one track a host thread under "program (host)",
    with `id`, `parent`, `trace` and the counts as args, and the device
    intervals on one "program (device)" track."""
    events = [{"ph": "M", "name": "process_name", "pid": pid, "args": {"name": label}}
              for pid, label in ((HOST_PID, "program (host)"), (DEVICE_PID, "program (device)"))]
    for tid in sorted({r["thread"] for r in records}):
        events.append({"ph": "M", "name": "thread_name", "pid": HOST_PID, "tid": tid,
                       "args": {"name": f"thread {tid}"}})
    for r in records:
        args = {"id": r["id"], "parent": r["parent"], "trace": r["trace"], **r["counts"]}
        tracks = [(HOST_PID, r["thread"], r["host_ns"])]
        if r["device_ns"] is not None:
            tracks.append((DEVICE_PID, 0, r["device_ns"]))
        for pid, tid, (s, e) in tracks:
            events.append({"ph": "X", "cat": "program", "name": r["name"], "pid": pid, "tid": tid,
                           "ts": (s - base_ns) / 1e3, "dur": (e - s) / 1e3, "args": args})
    return events


class Trace:
    """`with Trace('logpdf-16k', dir='traces'):` the torch profiler around
    a region (CPU, and CUDA when the card is there), under a
    `record_function` of that name.  The program's spans are on inside it
    (a profiler records).  With `dir` the trace is written there as
    `<name>.json` (chrome://tracing, Perfetto), with the spans opened inside
    the region added on the file's own clock (`baseTimeNanoseconds`); the
    profile stays in `.profile` and the spans in `.spans` either way, and
    leave the store (`spans()` no longer holds them)."""

    def __init__(self, name: str, dir: str | None = None):
        self.name, self.dir = name, dir
        self.profile = None
        self.spans = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.profile = profile(activities=acts)
        self._t0 = time.time_ns()
        self.profile.__enter__()
        self._rec = record_function(self.name)
        self._rec.__enter__()
        return self

    def __exit__(self, *exc):
        self._rec.__exit__(*exc)
        self.profile.__exit__(*exc)
        self.spans = _take((self._t0, time.time_ns()))
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, f"{self.name}.json")
            self.profile.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
            doc["traceEvents"].extend(chrome_events(self.spans, int(doc.get("baseTimeNanoseconds", 0))))
            with open(path, "w") as f:
                json.dump(doc, f)
        return False

"""The program's own spans, reduced to what a unit (a fit step or a request)
spends in each layer: the reading shared by the per-layer metrics that read
them (`metrics/factor_ms.*`, `reverse_ms.train`, `subst_ms.*`, `cov_ms.*`,
`chol_gemm_tflops.train`, `host_ms.request`).

The port records spans while a torch profiler records, so a traced run's
passes (`runner.traced_window` and the profiler's warm-up before it) leave
them in the program's tracer, `stheno_tpu_torch.utils.logging.spans()`; the
untraced window leaves none.  A program without that tracer, or one that
recorded no span of a name, reads None.

A record (`spans()`'s dicts): `name`, `id`, `parent`, `trace` (the id of
the outermost span of its call into the program), `thread`, `host_ns` and
`device_ns` (start, end on the host's clock; `device_ns` None where the span
recorded no device events) and `counts`.  The spans sharing a trace id are
one call; its root (the span whose id is the trace id) names it: `logpdf`
or `elbo` in a fit step (the reverse rules' spans are the forward's
children, so a step's backward belongs to its call), `posterior.mean` and
`posterior.var` in a query request, `entry.predict` in a predict request.
Of nested spans of one name only the outermost counts.

The per-unit rule reads the device-only pass's window alone.  The harness
runs the traced units in a fixed order, each unit one call of each root
name: the profiler's two warm-up units (`runner._profiler_warmup`), then
the device-only pass (`runner._device_pass`: one unit before its marker,
then the window's `trace_units`; again on each retry), then the annotated
pass's `trace_units`, whose recording of the host slows the units.  So of
each root name's calls in start order, the window's are the `trace_units`
before the last `trace_units`.  For each root name, the median over those
calls of the quantity; those medians summed over the names.  Records that
do not follow that order (too few calls, or a count no number of retries
gives) read None.
"""

from __future__ import annotations

from statistics import median


def records():
    """The program's closed spans, or [] where the program has no tracer."""
    try:
        from stheno_tpu_torch.utils import logging as tracer
    except ImportError:
        return []
    read = getattr(tracer, "spans", None)
    return list(read()) if read is not None else []


#: Units each traced run makes before the device-only pass: the profiler's
#: warm-up, one under each kind of pass.
WARMUP_UNITS = 2


def calls(recs):
    """`(root name, records)` of each call whose root was recorded, in the
    order the roots started."""
    by_trace = {}
    for r in recs:
        by_trace.setdefault(r["trace"], []).append(r)
    out = []
    for trace, call in by_trace.items():
        root = next((r for r in call if r["id"] == trace), None)
        if root is not None:
            out.append((root["host_ns"][0], root["name"], call))
    return [(name, call) for _, name, call in sorted(out, key=lambda c: c[:2])]


def window_calls(recs, units):
    """Root name -> the calls of the device-only pass's window (the
    `units` calls before the last `units`), or None where the records do
    not follow the harness's order."""
    by_root = {}
    for name, call in calls(recs):
        by_root.setdefault(name, []).append(call)
    if not by_root:
        return None
    out = {}
    for name, cs in by_root.items():
        rest = len(cs) - WARMUP_UNITS - units  # the device-only tries' units
        if rest < units + 1 or rest % (units + 1):
            return None
        out[name] = cs[len(cs) - 2 * units:len(cs) - units]
    return out


def outermost(call, names):
    """The spans of `call` named in `names` with no ancestor of their own name."""
    by_id = {r["id"]: r for r in call}
    out = []
    for r in call:
        if r["name"] not in names:
            continue
        p = r["parent"]
        while p in by_id and by_id[p]["name"] != r["name"]:
            p = by_id[p]["parent"]
        if p not in by_id:
            out.append(r)
    return out


def per_unit(run, recs, quantity):
    """Σ over root names of the median over that name's calls in the
    device-only window of `quantity(call)`; None where there is no such
    window (an untraced run, or records out of the harness's order)."""
    if not run.get("trace"):
        return None
    by_root = window_calls(recs, run["trace"]["units"])
    if by_root is None:
        return None
    return sum(median(quantity(call) for call in cs) for cs in by_root.values())


def _timed(recs, names):
    """Whether spans named in `names` were recorded, each with a device
    interval."""
    found = [r for r in recs if r["name"] in names]
    return bool(found) and all(r["device_ns"] is not None for r in found)


def device_ms(run, kinds, names):
    """Device milliseconds a unit in the outermost spans named in `names`."""
    if run["kind"] not in kinds:
        return None
    recs = records()
    if not _timed(recs, names):
        return None
    return per_unit(run, recs, lambda call: sum(r["device_ns"][1] - r["device_ns"][0]
                                                for r in outermost(call, names)) / 1e6)


def count(call, names, key):
    """The count `key` summed over the outermost spans named in `names`."""
    return sum(r["counts"].get(key, 0) for r in outermost(call, names))


def gemm_tflops(run, kinds, names):
    """The GEMMs' logical work (`gemm_flops`) a unit in the spans named in
    `names` over their device time a unit, in TFLOP/s."""
    ms = device_ms(run, kinds, names)
    if not ms:
        return None
    flops = per_unit(run, records(), lambda call: count(call, names, "gemm_flops"))
    return flops / (ms * 1e-3) / 1e12


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def host_ms(run, kinds):
    """Host milliseconds a unit inside the program's outermost spans (the
    union of its calls' host intervals, forward and reverse rules)."""
    if run["kind"] not in kinds:
        return None
    recs = records()
    if not recs:
        return None
    return per_unit(run, recs, lambda call: _union_ns([r["host_ns"] for r in call]) / 1e6)

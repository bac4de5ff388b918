"""Reduce a profiler trace to what the per-layer metrics read (a frozen copy
of `chip_smoke.py`'s `profile_ms` arithmetic: the device's busy time as the
union of its operations' intervals, and time by kernel kind through
`PROFILE_KINDS`).

Inputs are plain lists, so the reduction runs on synthetic events too:

- `device`: `(name, start_us, end_us)` of every operation that ran on the
  device (kernels, copies and fills);
- `spans`: `(name, start_us, end_us)` of the harness's host spans;
- `window`: `(start_us, end_us)` of the traced window, on the same clock.
"""

from __future__ import annotations

#: Device operations grouped by a substring of their lower-cased names; the
#: first group that matches takes the operation.
PROFILE_KINDS = (
    ("tf32_split", ("tf32_split",)),
    ("kernelmatrix", ("km_kernel",)),
    ("kernelmatrix_vjp", ("km_vjp",)),
    ("chol_block", ("chol_block_kernel",)),
    ("tri_inv_block", ("tri_inv_kernel",)),
    ("gemm", ("gemm",)),
    ("trsm", ("trsm", "trsv")),
    ("elementwise", ("elementwise",)),
    ("concatenate", ("catarray",)),
    ("reduce", ("reduce",)),
)

#: Device operations that are transfers, not kernels.
TRANSFERS = ("memcpy", "memset")

#: Longest names kept in a breakdown.
NAME_CHARS = 120


def kind_of(name):
    low = name.lower()
    return next((k for k, keys in PROFILE_KINDS if any(s in low for s in keys)), "other")


def is_kernel(name):
    low = name.lower()
    return not any(low.startswith(t) for t in TRANSFERS)


def clip(events, window):
    """The events cut to the window; those wholly outside it dropped."""
    w0, w1 = window
    out = []
    for name, s, e in events:
        s, e = max(s, w0), min(e, w1)
        if e > s or (e == s and w0 <= s <= w1):
            out.append((name, s, e))
    return out


def busy_intervals(device):
    """The union of the operations' intervals, as sorted disjoint pairs."""
    merged = []
    for _, s, e in sorted(device, key=lambda ev: (ev[1], ev[2])):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_gaps(intervals, window):
    """The stretches of the window in which no operation ran."""
    w0, w1 = window
    gaps, cur = [], w0
    for s, e in intervals:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    return gaps


def span_at(spans, t):
    """The innermost (shortest) host span covering time `t`, or None."""
    covering = [(e - s, name) for name, s, e in spans if s <= t < e]
    return min(covering)[1] if covering else None


def summarize(device, spans, window, top=10):
    """What the per-layer metrics read, in seconds: `window_s`, `busy_s`,
    `kernels` (device kernels, transfers left out), `by_kind_s`, and the
    breakdown's `device_ops` (the `top` names that took
    most device time) and `idle_gaps` (idle time summed by the host span
    active when each gap began, longest first; "outside spans" where none
    was)."""
    w0, w1 = window
    if w1 <= w0:
        raise ValueError(f"empty traced window {window}")
    device = clip(device, window)
    if not device:
        raise ValueError("the trace holds no device operation in its window")
    intervals = busy_intervals(device)
    busy_us = sum(e - s for s, e in intervals)
    by_name, by_kind = {}, {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        k = kind_of(name)
        by_kind[k] = by_kind.get(k, 0.0) + (e - s) / 1e6
    gaps_by_span = {}
    for s, e in idle_gaps(intervals, window):
        name = span_at(spans, s) or "outside spans"
        gaps_by_span[name] = gaps_by_span.get(name, 0.0) + (e - s) / 1e6
    ranked_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ranked_gaps = sorted(gaps_by_span.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernels": sum(1 for name, _, _ in device if is_kernel(name)),
        "by_kind_s": by_kind,
        "device_ops": [[name[:NAME_CHARS], t] for name, t in ranked_ops],
        "idle_gaps": [[name, t] for name, t in ranked_gaps],
    }

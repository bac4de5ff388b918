"""Observability: per-iteration scalar logging and profiler traces
(counterpart of `stheno_tpu/utils/logging.py`).

The reference streams scalars out of a compiled loop with
`jax.debug.callback`.  The port's loops run on the host, so `log_scalars`
calls its sink directly; reading a tensor on the card waits for it, so log
every N steps rather than every step.  `Trace` is the torch profiler
around a region, with the card's activity when there is one.
"""

from __future__ import annotations

import os
import sys

import torch


def _default_sink(tag, step, values):
    parts = " ".join(f"{k}={float(v):.5g}" for k, v in values.items())
    print(f"[{tag}] step {int(step):>6d}  {parts}", file=sys.stderr, flush=True)


def log_scalars(tag: str, step, every: int = 1, sink=None, **values):
    """Emit named scalars every `every` steps:

        log_scalars("fit", step=i, every=50, loss=loss, lr=lr)
    """
    if int(step) % every == 0:
        (sink or _default_sink)(tag, step, values)


class Trace:
    """`with Trace('logpdf-16k', dir='traces'):` the torch profiler around
    a region (CPU, and CUDA when the card is there), under a
    `record_function` of that name.  With `dir` the trace is written there
    as `<name>.json` (chrome://tracing, Perfetto); the profile stays in
    `.profile` either way."""

    def __init__(self, name: str, dir: str | None = None):
        self.name, self.dir = name, dir
        self.profile = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.profile = profile(activities=acts)
        self.profile.__enter__()
        self._rec = record_function(self.name)
        self._rec.__enter__()
        return self

    def __exit__(self, *exc):
        self._rec.__exit__(*exc)
        self.profile.__exit__(*exc)
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
            self.profile.export_chrome_trace(os.path.join(self.dir, f"{self.name}.json"))
        return False

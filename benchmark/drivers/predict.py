"""Traffic of kind `predict`: one caller, closed loop; each request brings
its own observations (a pool of `pool` data sets drawn from the seed in
set-up, taken in turn) and `points` query points, and gets a latent
process's marginals through the program's one-call prediction.  A request
is timed from its start until its means and variances are on the host.

Compared as in `query.py` (`mean`, `var`), each sampled request against the
reference's posterior from that request's own data.
"""

from __future__ import annotations

import time
from pathlib import Path

from harness.registry import load_module

_query = load_module(Path(__file__).with_name("query.py"), "driver")


class State:
    pass


def _request(ctx, st, i):
    data, xq = st.pool[i % len(st.pool)]
    t0 = time.perf_counter()
    mean, var = ctx.programme.predict(st.theta, data, xq, ctx.spans)
    return mean, var, time.perf_counter() - t0


def setup(ctx):
    st = State()
    st.theta = ctx.programme.theta(ctx.cfg, ctx.device)
    st.pool = [(ctx.programme.make_data(ctx.cfg, ctx.gen, ctx.device),
                ctx.programme.query_points(ctx.cfg, ctx.traffic, ctx.gen, ctx.device))
               for _ in range(ctx.traffic["pool"])]
    for i in range(ctx.traffic["warmup_requests"]):
        _request(ctx, st, i)
    st.next = 0
    st.done = []
    return st


def unit(ctx, st):
    _request(ctx, st, st.next)
    st.next += 1


def window(ctx, st, seconds):
    done = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = st.next
        st.next += 1
        done.append((i % len(st.pool), *_request(ctx, st, i)))
    window_s = time.perf_counter() - t0
    st.done = done
    return {"units": len(done), "window_s": window_s, "latencies_s": [d[3] for d in done],
            "points_per_unit": ctx.traffic["points"]}


def collect(ctx, st):
    pick = sorted(ctx.rng.sample(range(len(st.done)), min(ctx.traffic["sample"], len(st.done))))
    answers = []
    for i in pick:
        k, mean, var, _ = st.done[i]
        answers.append((k, mean, var))
    return {
        "pool": st.pool,
        "theta": {k: float(v) for k, v in st.theta.items()},
        "attempted": len(st.done),
        "failed": _query._failed(st.done),
        "answers": answers,
    }


def check(ctx, out):
    refs = []
    for k, _, _ in out["answers"]:
        data, xq = out["pool"][k]
        refs += ctx.reference.marginals(ctx.cfg, data, out["theta"], [xq])
    return _query.judge(ctx, [(None, m, v) for _, m, v in out["answers"]], refs)

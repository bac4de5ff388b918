"""Traffic of kind `query`: one caller holds a posterior built in set-up and
asks, one request after another (closed loop), for a latent process's
marginals at `points` fresh query points drawn from the seed.  A request is
timed from its start until its means and variances are on the host.

Compared, on `sample` requests drawn from the seed once the window has
closed, against the reference's posterior from the same data:

- `mean`: max |mean − reference| over max |reference mean|, worst request;
- `var`: max |variance − reference| over the prior variance, worst request.
"""

from __future__ import annotations

import time

import torch
from harness import compare


class State:
    pass


def _request(ctx, st, xq):
    t0 = time.perf_counter()
    mean, var = ctx.programme.query(st.post, xq, ctx.spans)
    return mean, var, time.perf_counter() - t0


def setup(ctx):
    st = State()
    st.data = ctx.programme.make_data(ctx.cfg, ctx.gen, ctx.device)
    st.theta = ctx.programme.theta(ctx.cfg, ctx.device)
    with ctx.spans("posterior"):
        st.post = ctx.programme.posterior(ctx.cfg, st.data, st.theta)
    for _ in range(ctx.traffic["warmup_requests"]):
        _request(ctx, st, ctx.programme.query_points(ctx.cfg, ctx.traffic, ctx.gen, ctx.device))
    st.done = []
    return st


def unit(ctx, st):
    _request(ctx, st, ctx.programme.query_points(ctx.cfg, ctx.traffic, ctx.gen, ctx.device))


def window(ctx, st, seconds):
    done = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        xq = ctx.programme.query_points(ctx.cfg, ctx.traffic, ctx.gen, ctx.device)
        done.append((xq, *_request(ctx, st, xq)))
    window_s = time.perf_counter() - t0
    st.done = done
    return {"units": len(done), "window_s": window_s, "latencies_s": [d[3] for d in done],
            "points_per_unit": ctx.traffic["points"]}


def _failed(done):
    return sum(1 for _, m, v, _ in done if not (torch.isfinite(m).all() and torch.isfinite(v).all()))


def collect(ctx, st):
    pick = sorted(ctx.rng.sample(range(len(st.done)), min(ctx.traffic["sample"], len(st.done))))
    return {
        "data": st.data,
        "theta": {k: float(v) for k, v in st.theta.items()},
        "attempted": len(st.done),
        "failed": _failed(st.done),
        "answers": [(st.done[i][0].cpu(), st.done[i][1], st.done[i][2]) for i in pick],
    }


def judge(ctx, answers, refs):
    if not answers:
        nan = float("nan")
        return [{"name": k, "value": nan, "limit": ctx.limits[k]} for k in ("mean", "var")]
    mean = max(compare.max_relative(m, r_m, r_m) for (_, m, _), (r_m, _, _) in zip(answers, refs))
    var = max(compare.max_relative(v, r_v, prior) for (_, _, v), (_, r_v, prior) in zip(answers, refs))
    return [{"name": "mean", "value": mean, "limit": ctx.limits["mean"]},
            {"name": "var", "value": var, "limit": ctx.limits["var"]}]


def check(ctx, out):
    refs = ctx.reference.marginals(ctx.cfg, out["data"], out["theta"], [a[0] for a in out["answers"]])
    return judge(ctx, out["answers"], refs)

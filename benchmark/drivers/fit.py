"""Traffic of kind `fit`: one user's full-batch fit, step after step, closed
loop.  A step is the objective's value, its gradient by torch.autograd and
an Adam update of the flat unconstrained θ (the body of the port's
`inference.fit` loop), with no synchronise of the harness's own.

Set-up builds the one fit (θ, its Adam state and the objective) and drives
it through its first steps (`first_steps`), which warm up every shape; the
window goes on with the same object.  Every `steps_per_fit` steps the fit
starts again from θ₀ with a fresh Adam state, so every run visits the same
parameters however fast it is.

What is compared (`harness/compare.py`), against the reference's value and
gradient and its own Adam from the same θ₀:

- `loss`: each first step's value, the worst relative gap;
- `grad`: the first gradient as Adam got it (its first moment after one
  step over 1 − β₁), the worst leaf's gap of norms;
- `change`: θ after the first steps less θ₀, the worst leaf's gap of norms,
  over the leaves the reference's first gradient moves;
- `window_loss`, `window_grad`: `window_samples` steps of the window drawn
  from the seed, the value and gradient at the θ each started from (the
  reference follows the program's θ there; the first steps check the
  start on their own).
"""

from __future__ import annotations

import math
import time

import torch
from harness import compare


class State:
    pass


def _restart_if_due(ctx, st):
    if st.k == ctx.traffic["steps_per_fit"]:
        with torch.no_grad():
            st.theta.copy_(st.theta0)
        st.opt.state.clear()
        st.k = 0


def _step(ctx, st):
    st.opt.zero_grad(set_to_none=True)
    with ctx.spans(st.problem.span):
        loss = st.problem.objective(st.theta)
    with ctx.spans("grad"):
        loss.backward()
    with ctx.spans("adam"):
        st.opt.step()
    st.k += 1
    return loss.detach()


def setup(ctx):
    st = State()
    st.data = ctx.programme.make_data(ctx.cfg, ctx.gen, ctx.device)
    st.problem = ctx.programme.fit_problem(ctx.cfg, st.data)
    st.theta0 = st.problem.theta0.detach().clone()
    st.theta = st.theta0.clone().requires_grad_(True)
    st.opt = torch.optim.Adam([st.theta], lr=ctx.cfg["adam_lr"])
    st.k = 0
    beta1 = st.opt.param_groups[0]["betas"][0]
    losses = []
    for i in range(ctx.traffic["first_steps"]):
        losses.append(_step(ctx, st))
        if i == 0:  # an optimizer that kept no state got no gradient
            moment = st.opt.state[st.theta].get("exp_avg", torch.zeros_like(st.theta))
            st.g1 = moment.detach().clone() / (1.0 - beta1)
    st.first_losses = torch.stack(losses)
    st.theta_first = st.theta.detach().clone()
    st.window = []
    return st


def unit(ctx, st):
    _restart_if_due(ctx, st)
    _step(ctx, st)


def window(ctx, st, seconds):
    rec = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _restart_if_due(ctx, st)
        before = st.theta.detach().clone()
        loss = _step(ctx, st)
        rec.append((before, loss, st.theta.grad.detach().clone()))
    ctx.sync()
    window_s = time.perf_counter() - t0
    st.window = rec
    return {"units": len(rec), "window_s": window_s}


def collect(ctx, st):
    """What the reference judges, on the host, and the sample drawn."""
    losses = torch.stack([loss for _, loss, _ in st.window]).cpu() if st.window else torch.zeros(0)
    pick = sorted(ctx.rng.sample(range(len(st.window)), min(ctx.traffic["window_samples"], len(st.window))))
    return {
        "data": st.data,
        "attempted": len(st.window),
        "failed": int((~torch.isfinite(losses)).sum()),
        "first_losses": st.first_losses.cpu().tolist(),
        "g1": st.g1.cpu(),
        "theta0": st.theta0.cpu(),
        "theta_first": st.theta_first.cpu(),
        "samples": [(st.window[i][0].cpu(), float(st.window[i][1]), st.window[i][2].cpu()) for i in pick],
        "adam": dict(st.opt.defaults),
    }


def reference_adam(ctx, data, theta0, steps, adam):
    """The reference's own fit from θ₀: its values, its first gradient and θ
    after `steps` Adam steps (torch.optim.Adam's update, written out)."""
    ref = ctx.reference
    lr, (b1, b2), eps = adam["lr"], adam["betas"], adam["eps"]
    th = theta0.to(torch.float64)
    m = torch.zeros_like(th)
    v = torch.zeros_like(th)
    values, g1 = [], None
    for t in range(1, steps + 1):
        val, g = ref.value_and_grad(ctx.cfg, data, th)
        g = g.to(torch.float64).cpu()
        g1 = g if g1 is None else g1
        values.append(val)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        denom = (v.sqrt() / math.sqrt(1.0 - b2**t)) + eps
        th = th - (lr / (1.0 - b1**t)) * m / denom
    return values, g1, th


def _nan_first(value):
    return math.inf if math.isnan(value) else value


def check(ctx, out):
    ref = ctx.reference
    leaves = ref.leaves(ctx.cfg)
    limits = ctx.limits
    values, g1_ref, th_ref = reference_adam(ctx, out["data"], out["theta0"],
                                            len(out["first_losses"]), out["adam"])
    theta0 = out["theta0"].to(torch.float64)
    numbers = {
        "loss": max(compare.relative_gap(p, r) for p, r in zip(out["first_losses"], values)),
        "grad": compare.worst_gap_of_norms(out["g1"], g1_ref, leaves),
        "change": compare.worst_gap_of_norms(out["theta_first"].to(torch.float64) - theta0,
                                             th_ref - theta0, leaves,
                                             keep=compare.moved_leaves(g1_ref, leaves)),
    }
    w_loss, w_grad = [], []
    for before, loss, grad in out["samples"]:
        if not torch.isfinite(before).all():  # the program's own state went wrong
            w_loss.append(math.nan)
            w_grad.append(math.nan)
            continue
        val, g = ref.value_and_grad(ctx.cfg, out["data"], before.to(torch.float64))
        w_loss.append(compare.relative_gap(loss, val))
        w_grad.append(compare.worst_difference(grad, g, leaves))
    if w_loss:
        numbers["window_loss"] = max(w_loss, key=_nan_first)
        numbers["window_grad"] = max(w_grad, key=_nan_first)
    return [{"name": k, "value": v, "limit": limits[k]} for k, v in numbers.items()]

"""Optimisation loops over a constrained parameter spec (counterpart of
`stheno_tpu/inference/vi.py:28-104`).

- `fit` minimises a scalar objective of the constrained parameters with
  `torch.optim.Adam`, whose update is optax's `adam` at the same defaults
  (β = (0.9, 0.999), ε = 1e-8).  The reference compiles the loop into one
  `lax.scan`; here it is a Python loop whose losses stay on the device
  until the end, so no step waits for the host unless `log_every` asks.
- `fit_lbfgs` runs `torch.optim.LBFGS` with a strong-Wolfe line search, one
  iteration per step.  Its steps are not optax's, so it reaches the same
  minimum by another path.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import torch

from stheno_tpu_torch import params as P


class FitResult(NamedTuple):
    params: dict
    theta: torch.Tensor
    losses: torch.Tensor


def _log(tag, step, loss):
    print(f"[{tag}] step {step:>6d}  loss={loss.item():.5g}", file=sys.stderr, flush=True)


def _result(theta, unflatten, losses):
    theta = theta.detach()
    with torch.no_grad():
        params = unflatten(theta)
    return FitResult(params, theta, torch.stack(losses).cpu())


def fit(objective, spec, num_steps=500, learning_rate=5e-2, log_every=0):
    """Minimise `objective(constrained params)` over the free leaves of
    `spec` for `num_steps` Adam steps at `learning_rate`.  `log_every=N`
    prints the loss to stderr every N steps.  Returns FitResult(final
    constrained params, flat θ, the loss at the start of each step, on the
    CPU)."""
    theta0, unflatten = P.init(spec)
    theta = theta0.clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=learning_rate)
    losses = []
    for i in range(num_steps):
        opt.zero_grad(set_to_none=True)
        loss = objective(unflatten(theta))
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if log_every and i % log_every == 0:
            _log("fit", i, loss)
    return _result(theta, unflatten, losses)


def fit_lbfgs(objective, spec, num_steps=100):
    """L-BFGS minimisation with a strong-Wolfe line search, one iteration
    per step (the reference's Optim.LBFGS path)."""
    theta0, unflatten = P.init(spec)
    theta = theta0.clone().requires_grad_(True)
    # one iteration a step: one evaluation at its start and up to 25 (the
    # line search's own default) in the line search, which torch caps at
    # max_eval less the evaluations already made
    opt = torch.optim.LBFGS([theta], max_iter=1, max_eval=26, line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad(set_to_none=True)
        loss = objective(unflatten(theta))
        loss.backward()
        return loss

    losses = [opt.step(closure).detach() for _ in range(num_steps)]
    return _result(theta, unflatten, losses)

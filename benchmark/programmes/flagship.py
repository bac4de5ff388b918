"""The flagship programme through the port (`stheno_tpu_torch`), and only
through its public entry points: f1 = v1·SE(·/l1), f2 = Matern32(·/l2),
f3 = f1 + f2 (`entry.build`), f3 observed under noise.

- `make_data`: x sorted uniform on the configuration's domain and
  y = sin x + 0.2 cos 7x + √noise·ε, drawn on the card from the seed's
  generator in a few large calls;
- `fit_problem`: −log p(y | θ) by `entry.nlml` over the flat unconstrained
  θ of `params.init` (each parameter positive: value = exp(raw));
- `posterior` and `query`: the posterior of f3 at the data
  (`finite_gp.posterior`), and f1's marginals at query points;
- `predict`: f1's marginals given a request's own data (`entry.predict`).
"""

from __future__ import annotations

import math
import torch
from harness.fit_problem import FitProblem, dtype

from stheno_tpu_torch import entry, finite_gp
from stheno_tpu_torch import params as P
from stheno_tpu_torch.inputs import GPPPInput

def _uniform(cfg, size, gen, device):
    lo, hi = cfg["domain"]
    return torch.rand(size, generator=gen, device=device, dtype=dtype(cfg)) * (hi - lo) + lo


def make_data(cfg, gen, device):
    x, _ = torch.sort(_uniform(cfg, cfg["n"], gen, device))
    eps = torch.randn(cfg["n"], generator=gen, device=device, dtype=dtype(cfg))
    y = torch.sin(x) + 0.2 * torch.cos(7.0 * x) + math.sqrt(cfg["data_noise"]) * eps
    return {"x": x, "y": y}


def theta(cfg, device):
    return {k: torch.tensor(v, dtype=dtype(cfg), device=device) for k, v in cfg["theta"].items()}


def fit_problem(cfg, data):
    spec = {k: P.positive(v) for k, v in theta(cfg, data["x"].device).items()}
    theta0, unflatten = P.init(spec)

    def objective(th):
        return entry.nlml(unflatten(th), data["x"], data["y"])

    return FitProblem(theta0, objective, "logpdf")


def posterior(cfg, data, th):
    with torch.no_grad():
        f = entry.build(th)
        return finite_gp.posterior(f(GPPPInput("f3", data["x"]), th["noise"]), data["y"])


def query_points(cfg, traffic, gen, device):
    return _uniform(cfg, traffic["points"], gen, device)


def query(post, xq, spans):
    with torch.no_grad():
        fq = post(GPPPInput("f1", xq))
        with spans("query.mean"):
            mean = fq.mean()
        with spans("query.var"):
            var = fq.var()
        with spans("copy"):
            return mean.cpu(), var.cpu()


def predict(th, data, xq, spans):
    with spans("predict"):
        mean, var = entry.predict(th, data["x"], data["y"], xq)
    with spans("copy"):
        return mean.cpu(), var.cpu()

"""The pseudo-point programme through the port (`stheno_tpu_torch`), and
only through its public entry points: f1 = v1·SE(·/l1),
f2 = v2·Matern52(·/l2), f3 = f1 + f2 observed under noise, pseudo-points
(f1 at z, f2 at z), the Titsias collapsed bound (`entry.pseudo_points_*`).

- `make_data`: x sorted uniform on [−w, w], y = sin(x/2) + 0.3·sin(2.5x + 1)
  + √noise·ε (the recipe of `entry.pseudo_points_data`), drawn on the card
  from the seed's generator, and z = linspace(−w, w, m);
- `fit_problem`: −ELBO by `entry.pseudo_points_neg_elbo` over the flat θ of
  `params.init` of the example's spec (positive parameters as exp(raw), z
  trained as it is), as `entry.pseudo_points_fit` does;
- `half_batch`: the fault of that name (`faults.py`) on the −ELBO's x and y.
"""

from __future__ import annotations

import math
import torch
from harness.fit_problem import FitProblem, dtype

from stheno_tpu_torch import entry
from stheno_tpu_torch import params as P

def make_data(cfg, gen, device):
    n, w, dt = cfg["n"], cfg["half_width"], dtype(cfg)
    x, _ = torch.sort(torch.rand(n, generator=gen, device=device, dtype=dt) * (2.0 * w) - w)
    eps = torch.randn(n, generator=gen, device=device, dtype=dt)
    y = torch.sin(x / 2.0) + 0.3 * torch.sin(2.5 * x + 1.0) + math.sqrt(cfg["data_noise"]) * eps
    z = torch.linspace(-w, w, cfg["m_per_latent"], dtype=dt, device=device)
    return {"x": x, "y": y, "z": z}


def fit_problem(cfg, data):
    dt, dev = data["x"].dtype, data["x"].device
    spec = {k: P.positive(torch.tensor(v, dtype=dt, device=dev)) for k, v in cfg["theta"].items()}
    spec["z"] = data["z"]
    theta0, unflatten = P.init(spec)
    triple = (data["x"], data["y"], data["z"])

    def objective(th):
        return entry.pseudo_points_neg_elbo(unflatten(th), triple)

    return FitProblem(theta0, objective, "neg_elbo")


def half_batch():
    import faults

    return faults.halving({entry: {"pseudo_points_neg_elbo": faults.objective(("data", 0), ("data", 1))}})

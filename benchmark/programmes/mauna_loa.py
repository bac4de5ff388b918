"""The two-output Mauna Loa programme through the port (`stheno_tpu_torch`),
and only through its public entry points: a shared trend under a CO₂ output
and a temperature output, each with its own wiggle, constant and noise, the
CO₂ one with a seasonal term (`entry.build_gp`, the model of
`examples/extended_mauna_loa`), observed jointly.

- `make_data`: the recipe of `entry.mauna_loa_data` (trend, quadratic, two
  seasonal harmonics and noise for CO₂; trend and noise for temperature;
  each output standardised) on evenly spaced times over the configuration's
  year ranges, time in years after `epoch`; the noise drawn on the card from
  the seed's generator;
- `fit_problem`: −log p(y_co2, y_T | θ) by `entry.mauna_loa_nlml` over the
  flat unconstrained θ of `params.init` of the port's own spec
  (`entry.mauna_loa_spec`), each leaf at the configuration's start value;
- `half_batch`: the fault of that name (`faults.py`) on the objective's
  observations, every other point of each output.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from harness.fit_problem import FitProblem, dtype

from stheno_tpu_torch import entry
from stheno_tpu_torch import params as P


def _standardised(v):
    return (v - v.mean()) / v.std(correction=0)


def make_data(cfg, gen, device):
    f64 = torch.float64
    t_co2 = torch.linspace(*cfg["years_co2"], cfg["n_co2"], dtype=f64, device=device)
    t_T = torch.linspace(*cfg["years_T"], cfg["n_T"], dtype=f64, device=device)
    eps_co2 = torch.randn(cfg["n_co2"], generator=gen, device=device, dtype=f64)
    eps_T = torch.randn(cfg["n_T"], generator=gen, device=device, dtype=f64)
    u_co2, u_T = (t_co2 - cfg["epoch"]) / 10.0, (t_T - cfg["epoch"]) / 10.0
    co2 = (0.8 * u_co2 + 0.05 * u_co2**2 + 0.35 * torch.sin(2 * math.pi * t_co2)
           + 0.12 * torch.cos(4 * math.pi * t_co2) + cfg["noise_co2"] * eps_co2)
    temp = 0.6 * u_T + cfg["noise_T"] * eps_T
    out = {"x_co2": t_co2 - cfg["epoch"], "y_co2": _standardised(co2),
           "x_T": t_T - cfg["epoch"], "y_T": _standardised(temp)}
    return {k: v.to(dtype(cfg)) for k, v in out.items()}


def _start(spec, values, dt, dev):
    """The port's spec with each leaf at `values`' number: a `Param` keeps
    its own constraint, a `Fixed` value stays fixed."""
    if isinstance(spec, dict):
        return {k: _start(v, values[k], dt, dev) for k, v in spec.items()}
    value = torch.tensor(values, dtype=dt, device=dev)
    if isinstance(spec, P.Fixed):
        return P.fixed(value)
    return dataclasses.replace(spec, raw=spec.inverse(value))


def fit_problem(cfg, data):
    dt, dev = data["x_co2"].dtype, data["x_co2"].device
    spec = _start(entry.mauna_loa_spec(dt, dev), cfg["theta"], dt, dev)
    theta0, unflatten = P.init(spec)
    observed = (data["x_co2"], data["y_co2"], data["x_T"], data["y_T"])

    def objective(th):
        return entry.mauna_loa_nlml(unflatten(th), observed)

    return FitProblem(theta0, objective, "logpdf")


def half_batch():
    import faults

    return faults.halving({entry: {"mauna_loa_nlml": faults.objective("data")}})

"""The five BASELINE workload model families as `@gppp` functions
(counterpart of `stheno_tpu/models/workloads.py:19-84`).  Each is a pure
function of its hyperparameters, rebuilt at every evaluation of an
objective (the reference's `build_model(θ)` idiom)."""

from __future__ import annotations

import math

import torch

from stheno_tpu_torch.gppp import gppp
from stheno_tpu_torch.graph import GP, Periodic, stretch
from stheno_tpu_torch.kernels import (
    ConstantKernel,
    Matern52Kernel,
    SEKernel,
    TransformedKernel,
    WhiteKernel,
    with_lengthscale,
)


@gppp
def process_decomposition(l1=1.0, l2=0.5):
    """f3 = f1 + f2."""
    f1 = GP(with_lengthscale(SEKernel(), l1))
    f2 = GP(with_lengthscale(SEKernel(), l2))
    return dict(f1=f1, f2=f2, f3=f1 + f2)


@gppp
def sensor_fusion():
    """A latent f observed through two sensors with structured noise."""
    f = GP(SEKernel())
    noise1 = math.sqrt(1e-2) * GP(WhiteKernel()) + (
        lambda x: torch.sin(x) - 5.0 + torch.sqrt(torch.abs(x))
    )
    noise2 = math.sqrt(1e-1) * GP(3.5, WhiteKernel())
    return dict(f=f, noise1=noise1, noise2=noise2, y1=f + noise1, y2=f + noise2)


@gppp
def mauna_loa_style(t):
    """A shared trend under two outputs, with per-output wiggle, seasonal
    and constant terms (the extended Mauna Loa model)."""
    f_trend = stretch(GP(SEKernel()), t["trend_scale"])
    co2 = t["co2"]
    f_co2 = (
        co2["s_latent"] * f_trend
        + co2["s_wiggle"] * stretch(GP(SEKernel()), co2["l_wiggle"])
        + co2["s_period"] * GP(TransformedKernel(SEKernel(), Periodic(co2["freq"])))
        + co2["s_mean"] * GP(ConstantKernel(1.0))
    )
    T = t["temp"]
    f_T = (
        T["s_trend"] * f_trend
        + T["s_wiggle"] * stretch(GP(SEKernel()), T["l_wiggle"])
        + T["s_mean"] * GP(ConstantKernel(1.0))
    )
    return dict(f_trend=f_trend, f_co2=f_co2, f_T=f_T)


@gppp
def pseudo_points_model(t):
    """f3 = f1 + f2, for interdomain pseudo-point inference."""
    f1 = GP(t["v1"] * with_lengthscale(SEKernel(), t["l1"]))
    f2 = GP(t["v2"] * with_lengthscale(Matern52Kernel(), t["l2"]))
    return dict(f1=f1, f2=f2, f3=f1 + f2)


@gppp
def hyperparameter_model(p):
    """A single output whose hyperparameters are learnt or sampled."""
    return dict(f=GP(p["v"] * with_lengthscale(SEKernel(), p["l"])))


WORKLOADS = {
    "process_decomposition": process_decomposition,
    "sensor_fusion": sensor_fusion,
    "extended_mauna_loa": mauna_loa_style,
    "gppp_and_pseudo_points": pseudo_points_model,
    "turing_integration": hyperparameter_model,
}

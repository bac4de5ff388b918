"""Time-varying Bayesian linear regression (`examples/time_varying_blr.py`)
on the port: known basis functions g1(x) = x/4 and g2 = cos, slowly varying
GP coefficients w1 and w2, y = g1·w1 + g2·w2 + a rough Matern12 "noise"
process; the coefficient trajectories are read off the posterior.
`w1 * g1` is a function-scaled process (`ScaledFnGP`).

    python -m stheno_tpu_torch.examples.time_varying_blr [--device cpu]

The observations are a prior draw from a CPU `torch.Generator` seeded 123456,
the reference's key number; the inputs come from numpy's
`default_rng(123456)`.
"""

from __future__ import annotations

import numpy as np
import torch

from stheno_tpu_torch import BlockData, GPPPInput, marginals, posterior, rand, split
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.examples._common import check, run_cli, tensor
from stheno_tpu_torch.gppp import gppp
from stheno_tpu_torch.graph import GP, stretch
from stheno_tpu_torch.kernels import Matern12Kernel, SEKernel

N = 250


def g1(x):
    return x / 4.0


g2 = torch.cos


@gppp
def model():
    w1 = stretch(GP(SEKernel()), 0.2)
    w2 = stretch(GP(SEKernel()), 1.0)
    f = w1 * g1 + w2 * g2
    y = f + 0.3 * GP(Matern12Kernel())
    return dict(w1=w1, w2=w2, f=f, y=y)


def data(dev):
    """y observed at 250 sorted uniform points of [0, 10]."""
    rng = np.random.default_rng(123456)
    return GPPPInput("y", tensor(np.sort(rng.uniform(0, 10, N)), dev))


def query(dev):
    """w1, w2, f and y at 500 points of [−2.5, 12.5]."""
    xp = torch.linspace(-2.5, 12.5, 500, dtype=torch.float64, device=dev)
    return BlockData(*(GPPPInput(name, xp) for name in ("w1", "w2", "f", "y")))


def main(device="cuda", fast=False):
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(123456)
    g = model()
    x = data(dev)
    yhat = rand(gen, g(x, 1e-9))
    post = posterior(g(x, 1e-9), yhat)
    xp_all = query(dev)
    xp = xp_all.blocks[0].x
    ms = marginals(post(xp_all, 1e-9))
    m_w1, m_w2, m_f, m_y = split(xp_all, ms.mean)
    _, v_w2, _, _ = split(xp_all, ms.var)

    # E[f] = g1·E[w1] + g2·E[w2] exactly; E[y] differs, the Matern12 "noise"
    # being correlated, with a posterior mean of its own near the data
    out = {"recon_err": (g1(xp) * m_w1 + g2(xp) * m_w2 - m_f).abs().max().item(),
           "noise_posterior_mean": (m_y - m_f).abs().max().item()}
    print(f"|g1 E[w1] + g2 E[w2] - E[f]|_inf = {out['recon_err']:.2e}")
    check(out["recon_err"] < 1e-8, f"E[f] is not the mix of E[w1] and E[w2]: {out['recon_err']}")
    print(f"correlated-noise posterior contribution |E[y]-E[f]|_inf = "
          f"{out['noise_posterior_mean']:.3f}")

    # the coefficients are better identified inside the data than outside
    inside = (xp > 0) & (xp < 10)
    out["w2_var_inside"], out["w2_var_outside"] = v_w2[inside].mean().item(), v_w2[~inside].mean().item()
    check(out["w2_var_inside"] < out["w2_var_outside"],
          f"w2's variance inside the data {out['w2_var_inside']} >= outside {out['w2_var_outside']}")

    ys = rand(gen, post(xp_all, 1e-9), 100)
    check(bool(torch.isfinite(ys).all()), "the joint posterior samples are not finite")
    out["w2_sd_inside"] = v_w2[inside].sqrt().mean().item()
    out["w2_sd_outside"] = v_w2[~inside].sqrt().mean().item()
    print(f"posterior sd of w2 inside data: {out['w2_sd_inside']:.3f}; "
          f"outside: {out['w2_sd_outside']:.3f}")
    print("time_varying_blr: OK")
    return out


if __name__ == "__main__":
    run_cli(main, __doc__)

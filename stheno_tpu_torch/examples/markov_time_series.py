"""Exact large-N time series through the state-space tier
(`examples/markov_time_series.py`) on the port: a Matérn-mixture GP at
N = 100 000 irregular time points (`--fast`: 20 000), with its logpdf,
its hyperparameters' training and its posterior marginals all O(N)
(`markov`: a parallel Kalman filter and smoother by associative scan).

Checks:

- the Markov logpdf equals the dense GPPP logpdf at N = 600 to 1e-7
  relative (the dense side through kernel 1);
- Adam on the Markov nlml recovers the generating hyperparameters;
- the posterior marginals at held-out sites beat the prior RMSE, and the
  95 % band covers the truth more than 90 % of the time.

    python -m stheno_tpu_torch.examples.markov_time_series [--device cpu] [--fast]

The data is a prior draw of the state-space model (`sample_markov`) from
a CPU `torch.Generator` seeded 0, the reference's key number; the inputs come
from numpy's `default_rng(0)`.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from stheno_tpu_torch import logpdf
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.examples._common import check, numpy, run_cli, tensor
from stheno_tpu_torch.graph import GP, GPC
from stheno_tpu_torch.kernels import Matern12Kernel, Matern32Kernel, with_lengthscale
from stheno_tpu_torch.markov import (
    _discretise,
    associative_scan,
    markov_gp_logpdf,
    markov_gp_posterior_marginals,
)

NOISE = 0.1
#: the truth: a slow Matern32 trend and a fast Matern12 wiggle, (v1, l1, v2, l2)
THETA_TRUE = (1.5, 8.0, 0.4, 0.5)
#: the deliberately wrong start of the training
THETA_START = (1.0, 3.0, 1.0, 1.5)
DENSE_N = 600


def make_kernel(logp):
    v1, l1, v2, l2 = torch.exp(logp)
    return (v1 * with_lengthscale(Matern32Kernel(), l1)
            + v2 * with_lengthscale(Matern12Kernel(), l2))


def _affine(e1, e2):
    """Two affine steps s ↦ A s + b, the earlier `e1`, composed."""
    A1, b1 = e1
    A2, b2 = e2
    return A2 @ A1, (A2 @ b1[..., None])[..., 0] + b2


def factors(kernel, x, dtype):
    """`(A, L, H)` of the discretised SDE at sorted `x`: the transitions,
    the factors of the process noises Q_k (jittered by 1e-12·tr P∞, Q_0
    being P∞) and the observation row."""
    A, Q, H = _discretise(kernel, x, dtype)
    eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    return A, torch.linalg.cholesky(Q + 1e-12 * torch.trace(Q[0]) * eye), H


def propagate(A, L, H, zs, eps_y, noise):
    """The prior draw given its standard normal draws, state innovations
    `zs` (N, d) and observation noise `eps_y` (N,): the recursion
    s_k = A_k s_{k−1} + L_k z_k runs as one associative scan of affine
    maps, O(log N) deep; f_k = H s_k, y_k = f_k + √noise·eps_y."""
    _, s = associative_scan(_affine, (A, (L @ zs[..., None])[..., 0]))
    return s @ H + math.sqrt(noise) * eps_y


def sample_markov(kernel, x, noise, gen):
    """O(N) prior draw of y at sorted `x` (a dense N-point draw would be
    O(N³)), its normal draws from the `torch.Generator` `gen`, made on its
    own device and moved to x's."""
    A, L, H = factors(kernel, x, x.dtype)
    zs = torch.randn(x.shape[0], L.shape[-1], generator=gen, dtype=x.dtype, device=gen.device)
    eps_y = torch.randn(x.shape[0], generator=gen, dtype=x.dtype, device=gen.device)
    return propagate(A, L, H, zs.to(x.device), eps_y.to(x.device), noise)


def nlml(logp, x, y, noise=NOISE):
    """The Markov −logpdf per point."""
    return -markov_gp_logpdf(make_kernel(logp), x, y, noise) / x.shape[0]


def main(device="cuda", fast=False, n=None, num_steps=None):
    dev = resolve_device(device)
    f64 = torch.float64
    n = n or (20_000 if fast else 100_000)
    num_steps = num_steps or (60 if fast else 80)
    rng = np.random.default_rng(0)
    x = tensor(np.sort(rng.uniform(0.0, 400.0, n)), dev)
    logp_true = torch.log(tensor(THETA_TRUE, dev))
    with torch.no_grad():
        y = sample_markov(make_kernel(logp_true), x, NOISE,
                          torch.Generator().manual_seed(0))

    # -- exactness against the dense path at reduced N -------------------------
    with torch.no_grad():
        lp_m = markov_gp_logpdf(make_kernel(logp_true), x[:DENSE_N], y[:DENSE_N], NOISE).item()
        f = GP(make_kernel(logp_true), gpc=GPC())
        lp_d = logpdf(f(x[:DENSE_N], NOISE), y[:DENSE_N]).item()
    out = {"n": n, "markov_logpdf": lp_m, "dense_logpdf": lp_d,
           "dense_rel_err": abs(lp_m - lp_d) / abs(lp_d)}
    check(out["dense_rel_err"] < 1e-7, f"Markov against dense logpdf at N={DENSE_N}: {out}")
    print(f"exactness at N={DENSE_N}: markov {lp_m:.4f} == dense {lp_d:.4f}")

    # -- Adam on the O(N) nlml over the whole N ---------------------------------
    logp = torch.log(tensor(THETA_START, dev))
    m, vv = torch.zeros_like(logp), torch.zeros_like(logp)
    lr, b1, b2 = 0.08, 0.9, 0.999
    t0 = time.time()
    for i in range(1, num_steps + 1):
        lp = logp.clone().requires_grad_(True)
        v = nlml(lp, x, y)
        (g,) = torch.autograd.grad(v, lp)
        m = b1 * m + (1 - b1) * g
        vv = b2 * vv + (1 - b2) * g * g
        logp = logp - lr * (m / (1 - b1**i)) / (torch.sqrt(vv / (1 - b2**i)) + 1e-8)
        if i % 20 == 0:
            print(f"  step {i:3d} nlml/N {v.item():.4f} theta {np.round(numpy(logp.exp()), 3)}")
    out["train_s"] = time.time() - t0
    print(f"trained N={n} in {out['train_s']:.1f}s ({num_steps} Adam steps, O(N) logpdf+grad each)")
    err = numpy((logp - logp_true).abs())
    out["theta"], out["log_err"] = numpy(logp.exp()).tolist(), err.tolist()
    check(bool(np.all(err < 0.7)), f"hyperparameters off in log-space: {err}")
    print(f"recovered {np.round(numpy(logp.exp()), 3)} (truth {np.array(THETA_TRUE)})")

    # -- posterior marginals at held-out sites ----------------------------------
    xs = tensor(np.sort(rng.uniform(5.0, 395.0, 2000)), dev)
    ys_true = np.interp(numpy(xs), numpy(x), numpy(y))  # dense x: fine
    with torch.no_grad():
        mean, var = markov_gp_posterior_marginals(make_kernel(logp), x, y, NOISE, x_star=xs)
    mean, var = numpy(mean), numpy(var)
    out["rmse"] = float(np.sqrt(np.mean((mean - ys_true) ** 2)))
    out["prior_rmse"] = float(np.sqrt(np.mean(ys_true**2)))
    out["coverage"] = float(np.mean(np.abs(mean - ys_true) < 1.96 * np.sqrt(var + NOISE)))
    print(f"held-out rmse {out['rmse']:.4f} (prior {out['prior_rmse']:.4f}); 95% band coverage "
          f"{out['coverage']:.3f}")
    check(out["rmse"] < 0.5 * out["prior_rmse"], f"held-out rmse {out}")
    check(out["coverage"] > 0.9, f"band coverage {out['coverage']}")
    print("markov_time_series: OK")
    return out


if __name__ == "__main__":
    run_cli(main, __doc__)

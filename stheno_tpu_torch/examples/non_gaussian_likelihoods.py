"""Non-Gaussian observation models (`examples/non_gaussian_likelihoods.py`)
on the port: classification and counts.

1. Probit GP classification by the Laplace approximation
   (`inference.laplace`), its hyperparameters learnt by maximising the
   Laplace evidence, whose gradient runs back through the damped Newton
   steps (60 Adam steps);
2. Poisson counts observed through f3 = trend + wiggle, the latent trend
   read off the Laplace posterior by cross-process prediction;
3. a non-conjugate SVGP trained by Adam on the quadrature ELBO (300 steps).

Each checks held-out accuracy, latent recovery or the bound's progress.

    python -m stheno_tpu_torch.examples.non_gaussian_likelihoods [--device cpu]

The host draws (inputs, labels, counts) come from one numpy
`default_rng(0)` in the reference's order; the latent functions are prior
draws from CPU `torch.Generator`s seeded 0 and 3, the reference's key numbers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from stheno_tpu_torch import BlockData, GPPPInput, rand
from stheno_tpu_torch import params as P
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.examples._common import check, numpy, run_cli, tensor
from stheno_tpu_torch.gppp import gppp
from stheno_tpu_torch.graph import GP, GPC
from stheno_tpu_torch.inference import (
    SVGP,
    BernoulliLikelihood,
    PoissonLikelihood,
    fit,
    laplace,
    svgp_elbo,
    svgp_init,
    svgp_posterior,
)
from stheno_tpu_torch.kernels import Matern32Kernel, SEKernel, with_lengthscale

N = 120
LIK = BernoulliLikelihood()  # probit


def se_gp(v, l):  # noqa: E741
    """GP(v·SE(·/l)) in a programme of its own."""
    return GP(v * with_lengthscale(SEKernel(), l), gpc=GPC())


def neg_evidence(p, x, y):
    """−(Laplace log evidence) of the labels y under GP(v·SE(·/l)) at x."""
    return -laplace(se_gp(p["v"], p["l"])(x, 1e-9), y, LIK, num_iters=20).log_evidence


@gppp
def build(t):
    trend = GP(with_lengthscale(SEKernel(), 2.5))
    wiggle = GP(0.3 * with_lengthscale(Matern32Kernel(), 0.4))
    return dict(trend=trend, wiggle=wiggle, f3=trend + wiggle)


def svgp_neg_elbo(q, g, x, y):
    """−ELBO of the labels under the SVGP state `q` over the process g."""
    return -svgp_elbo(q, g(x, 1e-9), y, likelihood=LIK)


def main(device="cuda", fast=False, evidence_steps=60, svgp_steps=300):
    dev = resolve_device(device)
    f64 = torch.float64
    rng = np.random.default_rng(0)
    out = {}

    # -- 1. probit classification, Laplace, evidence-learnt hyperparameters --
    print("== probit GP classification (Laplace) ==")
    x = tensor(np.sort(rng.uniform(-4, 4, N)), dev)
    x_test = torch.linspace(-3.8, 3.8, 200, dtype=f64, device=dev)
    f_latent = rand(torch.Generator().manual_seed(0),
                    se_gp(2.0, 1.0)(torch.cat([x, x_test]), 1e-9))
    f_tr, f_te = f_latent[:N], f_latent[N:]
    Phi = torch.distributions.Normal(0.0, 1.0).cdf(f_tr)
    y = (tensor(rng.uniform(size=N), dev) < Phi).to(f64)
    y_te = f_te > 0

    t0 = time.time()
    spec = dict(v=P.positive(tensor(1.0, dev)), l=P.positive(tensor(0.5, dev)))
    res = fit(lambda p: neg_evidence(p, x, y), spec, num_steps=evidence_steps, learning_rate=0.1)
    p_hat = {k: v.detach() for k, v in res.params.items()}
    out.update(v=p_hat["v"].item(), l=p_hat["l"].item(), evidence_fit_s=time.time() - t0)
    print(f"  learned: v={out['v']:.2f} l={out['l']:.2f} (evidence fit {out['evidence_fit_s']:.1f}s)")

    g = se_gp(p_hat["v"], p_hat["l"])
    with torch.no_grad():
        fit_res = laplace(g(x, 1e-9), y, LIK, num_iters=25)
        p_te, _ = LIK.predictive_mean_var(fit_res.posterior.mean(x_test),
                                          fit_res.posterior.var(x_test))
    out["accuracy"] = ((p_te > 0.5) == y_te).double().mean().item()
    out["newton_decrement"] = fit_res.newton_decrement.item()
    print(f"  held-out accuracy: {out['accuracy']:.3f}   newton decrement "
          f"{out['newton_decrement']:.2e}")
    check(out["accuracy"] > 0.85, f"held-out accuracy {out['accuracy']}")
    check(out["newton_decrement"] < 1e-8, f"Newton decrement {out['newton_decrement']}")

    # -- 2. Poisson counts on f3 = trend + wiggle, latent trend recovered ----
    print("== Poisson counts on f3 = trend + wiggle (Laplace, cross-process) ==")
    prog = build({})
    xc = tensor(np.sort(rng.uniform(-4, 4, 150)), dev)
    with torch.no_grad():
        joint = rand(torch.Generator().manual_seed(3),
                     prog(BlockData(GPPPInput("f3", xc), GPPPInput("trend", xc)), 1e-9))
        f3_true, trend_true = numpy(joint[:150]), numpy(joint[150:])
        counts = tensor(rng.poisson(np.exp(f3_true)), dev)
        resP = laplace(prog(GPPPInput("f3", xc), 1e-9), counts, PoissonLikelihood(), num_iters=30)
        f3_hat = numpy(resP.posterior.mean(GPPPInput("f3", xc)))
        trend_hat = numpy(resP.posterior.mean(GPPPInput("trend", xc)))
        v_post = resP.posterior.var(GPPPInput("trend", xc))
        v_prior = prog.var(GPPPInput("trend", xc))
    out["corr_f3"] = float(np.corrcoef(f3_hat, f3_true)[0, 1])
    out["corr_trend"] = float(np.corrcoef(trend_hat, trend_true)[0, 1])
    out["poisson_newton_decrement"] = resP.newton_decrement.item()
    print(f"  log-intensity correlation: f3 {out['corr_f3']:.3f}, latent trend "
          f"{out['corr_trend']:.3f}")
    # the observed process is well determined; the trend/wiggle split only
    # partly, from counts, so its bar is lower
    check(out["corr_f3"] > 0.85, f"f3 correlation {out['corr_f3']}")
    check(out["corr_trend"] > 0.5, f"trend correlation {out['corr_trend']}")
    check(out["poisson_newton_decrement"] < 1e-7,
          f"Poisson Newton decrement {out['poisson_newton_decrement']}")
    check(bool((v_post < v_prior).all() and (v_post > 0).all()),
          "the counts should shrink the trend's variance, and keep it positive")

    # -- 3. non-conjugate SVGP (Bernoulli ELBO, Adam) -------------------------
    print("== non-conjugate SVGP (Bernoulli ELBO, Adam) ==")
    fz = g(torch.linspace(-3.8, 3.8, 20, dtype=f64, device=dev), 1e-9)  # the learnt kernel
    q0 = svgp_init(fz)
    with torch.no_grad():
        out["elbo_first"] = -svgp_neg_elbo(q0, g, x, y).item()
    q_mu, q_sqrt = q0.q_mu.clone().requires_grad_(True), q0.q_sqrt.clone().requires_grad_(True)
    opt = torch.optim.Adam([q_mu, q_sqrt], lr=0.1)
    for _ in range(svgp_steps):
        opt.zero_grad(set_to_none=True)
        loss = svgp_neg_elbo(SVGP(fz, q_mu, q_sqrt), g, x, y)
        loss.backward()
        opt.step()
    out["elbo_last"] = -loss.item()
    with torch.no_grad():
        post = svgp_posterior(SVGP(fz, q_mu.detach(), q_sqrt.detach()))
        p_sv, _ = LIK.predictive_mean_var(post.mean(x_test), post.var(x_test))
    out["svgp_accuracy"] = ((p_sv > 0.5) == y_te).double().mean().item()
    print(f"  ELBO {out['elbo_first']:.1f} → {out['elbo_last']:.1f}; held-out accuracy "
          f"{out['svgp_accuracy']:.3f}")
    check(out["elbo_last"] > out["elbo_first"] + 1.0, f"the ELBO did not improve: {out}")
    check(out["svgp_accuracy"] > 0.85, f"SVGP held-out accuracy {out['svgp_accuracy']}")
    # SVGP and Laplace agree on the decision function
    out["agreement"] = ((p_sv > 0.5) == (p_te > 0.5)).double().mean().item()
    print(f"  SVGP/Laplace decision agreement: {out['agreement']:.3f}")
    check(out["agreement"] > 0.9, f"SVGP/Laplace agreement {out['agreement']}")
    print("non_gaussian_likelihoods: OK")
    return out


if __name__ == "__main__":
    run_cli(main, __doc__)

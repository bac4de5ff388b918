"""Getting started (`examples/getting_started.py`) on the port, the
reference's full tour: exact inference in a GPPP, then three ways to learn
its hyperparameters, with the constrained-parameter utilities (`params`):

1. exact inference: f1 = s1·Matern52(·/l1), f2 = s2·SE(·/l2), f3 = f1 + f2,
   f3 observed under noise, the posterior read off at every process;
2. Nelder–Mead (scipy, gradient-free) and BFGS with exact gradients (scipy
   on the host, each evaluation the port's f64 −logpdf and its gradient on
   the device);
3. NUTS over 4 chains (`inference.run_nuts`): the log-density is a
   `torch.func.vmap` over the chains, so kernel 1 makes one batched
   Matérn 5/2 launch in f64 for all of them; R̂, ESS and the noise's
   posterior against the truth.

    python -m stheno_tpu_torch.examples.getting_started [--device cpu] [--fast]

`--fast` takes the example's shorter counts (Nelder–Mead 300 iterations,
BFGS 120, NUTS 80 + 120).  The observations are a prior draw from a
CPU `torch.Generator` seeded 0 and NUTS runs from seed 0, the reference's key
number; the start's perturbation comes from numpy's `default_rng(42)`.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.optimize
import torch

from stheno_tpu_torch import GPPPInput, logpdf, marginals, posterior, rand
from stheno_tpu_torch import params as P
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.examples._common import check, numpy, run_cli, tensor
from stheno_tpu_torch.gppp import gppp
from stheno_tpu_torch.graph import GP, stretch
from stheno_tpu_torch.inference import effective_sample_size, potential_scale_reduction, run_nuts
from stheno_tpu_torch.kernels import Matern52Kernel, SEKernel

#: a short lengthscale and small variance; a long lengthscale and a larger
#: variance (script.jl:27-33)
TRUTH = dict(l1=0.4, s1=0.2, l2=5.0, s2=1.0)
NOISE_TRUE = 0.02


@gppp
def build_model(t):
    f1 = t["s1"] * stretch(GP(Matern52Kernel()), 1.0 / t["l1"])
    f2 = t["s2"] * stretch(GP(SEKernel()), 1.0 / t["l2"])
    return dict(f1=f1, f2=f2, f3=f1 + f2)


def spec(dev):
    """The example's spec at the truth, the noise learnt too, at least 1e-3
    (script.jl:134)."""
    return dict({k: P.positive(tensor(v, dev)) for k, v in TRUTH.items()},
                s_noise=P.positive(tensor(0.1, dev), lb=1e-3))


def nlml_fn(x, y, unflatten):
    """−log p(y | θ) of f3 at x, θ the flat unconstrained vector."""
    def nlml(theta):
        t = unflatten(theta)
        return -logpdf(build_model(t)(x, t["s_noise"] + 1e-6), y)
    return nlml


def main(device="cuda", fast=False, nm_maxiter=None, bfgs_maxiter=None, num_warmup=None,
         num_samples=None):
    dev = resolve_device(device)
    nm_maxiter = nm_maxiter or (300 if fast else 2000)
    bfgs_maxiter = bfgs_maxiter or (120 if fast else 500)
    num_warmup = num_warmup or (80 if fast else 150)
    num_samples = num_samples or (120 if fast else 250)
    gen = torch.Generator().manual_seed(0)
    out = {}

    # -- exact inference in a GP (script.jl:15-99) ---------------------------
    f = build_model({k: tensor(v, dev) for k, v in TRUTH.items()})
    x = GPPPInput("f3", torch.linspace(-5.0, 5.0, 100, dtype=torch.float64, device=dev))
    fx = f(x, NOISE_TRUE)
    y = rand(gen, fx)
    out["lml_true"] = logpdf(fx, y).item()
    print(f"log marginal likelihood under the true model: {out['lml_true']:.3f}")

    with torch.no_grad():
        f_post = posterior(fx, y)
        x_plot = torch.linspace(-7.0, 7.0, 200, dtype=torch.float64, device=dev)
        for pname in ("f3", "f2", "f1"):
            ms = marginals(f_post(GPPPInput(pname, x_plot), 1e-9))
            check(bool((ms.var > -1e-9).all()), f"negative posterior variance of {pname}")
            print(f"posterior over {pname}: mean in [{ms.mean.min().item():+.2f}, "
                  f"{ms.mean.max().item():+.2f}]")
        smp = rand(gen, f_post(GPPPInput("f3", x_plot), 1e-9), 10)
        check(tuple(smp.shape) == (200, 10), f"posterior samples' shape {tuple(smp.shape)}")
        # the posterior interpolates: its rmse at the data ≪ the prior's
        m_at_x = marginals(f_post(x, 1e-9)).mean
    out["rmse_post"] = torch.sqrt(torch.mean((m_at_x - y) ** 2)).item()
    out["rmse_prior"] = torch.sqrt(torch.mean(y**2)).item()
    print(f"rmse at data: posterior {out['rmse_post']:.4f} vs prior {out['rmse_prior']:.4f}")
    check(out["rmse_post"] < 0.3 * out["rmse_prior"], f"the posterior does not interpolate: {out}")

    # -- Nelder–Mead (script.jl:100-160) -------------------------------------
    theta0, unflatten = P.init(spec(dev))
    nlml = nlml_fn(x, y, unflatten)
    theta_init = numpy(theta0) + 0.1 * np.random.default_rng(42).normal(size=theta0.shape)

    def value(t):
        with torch.no_grad():
            return nlml(tensor(t, dev)).item()

    out["nlml0"] = value(theta_init)
    t0 = time.time()
    res_nm = scipy.optimize.minimize(value, theta_init, method="Nelder-Mead",
                                     options=dict(maxiter=nm_maxiter, xatol=1e-6, fatol=1e-8))
    out.update(nm_nlml=float(res_nm.fun), nm_iters=int(res_nm.nit), nm_s=time.time() - t0)
    print(f"Nelder-Mead: nlml {out['nlml0']:.2f} → {res_nm.fun:.2f} ({res_nm.nit} iters, "
          f"{out['nm_s']:.1f}s)")
    check(res_nm.fun < out["nlml0"], "Nelder-Mead did not improve on the start")

    # -- BFGS with exact gradients (script.jl:205-230) ------------------------
    def value_and_grad(t):
        theta = tensor(t, dev).requires_grad_(True)
        v = nlml(theta)
        (g,) = torch.autograd.grad(v, theta)
        return v.item(), numpy(g).astype(float)

    t0 = time.time()
    res_bfgs = scipy.optimize.minimize(value_and_grad, theta_init, jac=True, method="BFGS",
                                       options=dict(maxiter=bfgs_maxiter))
    out.update(bfgs_nlml=float(res_bfgs.fun), bfgs_iters=int(res_bfgs.nit),
               bfgs_s=time.time() - t0)
    print(f"BFGS:        nlml {out['nlml0']:.2f} → {res_bfgs.fun:.2f} ({res_bfgs.nit} iters, "
          f"{out['bfgs_s']:.1f}s)")
    check(res_bfgs.fun <= res_nm.fun + 1.0, "BFGS should be about as good as Nelder-Mead")
    t_opt = unflatten(tensor(res_bfgs.x, dev))
    out["learnt"] = {k: v.item() for k, v in t_opt.items()}
    print("  learnt:", {k: round(v, 3) for k, v in out["learnt"].items()})
    check(0.2 * NOISE_TRUE < out["learnt"]["s_noise"] < 5 * NOISE_TRUE,
          f"the learnt noise {out['learnt']['s_noise']} is far from the truth {NOISE_TRUE}")
    # the optimum's lml beats the initial hyperparameters'
    with torch.no_grad():
        out["lml_opt"] = logpdf(build_model(t_opt)(x, t_opt["s_noise"]), y).item()
    check(out["lml_opt"] >= -res_nm.fun - 1e-6, f"lml at the BFGS optimum {out['lml_opt']}")
    print(f"lml at BFGS optimum: {out['lml_opt']:.3f} (true-model lml {out['lml_true']:.3f})")

    # -- NUTS (script.jl:239-263): -nlml plus a standard-normal prior on θ --
    def logdensity(theta):
        return -nlml(theta) - 0.5 * torch.sum(theta**2)

    t0 = time.time()
    samples, info = run_nuts(0, logdensity, tensor(theta_init, dev), num_warmup=num_warmup,
                             num_samples=num_samples, num_chains=4)
    out["nuts_s"] = time.time() - t0
    out["divergent_share"] = info.diverging.double().mean().item()
    print(f"NUTS: 4 chains x {num_samples} samples in {out['nuts_s']:.1f}s; divergences "
          f"{out['divergent_share']:.2%}")
    flat = samples.reshape(-1, samples.shape[-1])
    s_noise = torch.func.vmap(lambda t: unflatten(t)["s_noise"])(flat).reshape(samples.shape[:2])
    out["rhat"] = potential_scale_reduction(torch.log(s_noise)).item()
    out["ess"] = effective_sample_size(torch.log(s_noise)).item()
    sn = numpy(s_noise)
    out["s_noise_mean"] = float(sn.mean())
    out["s_noise_q01"], out["s_noise_q99"] = float(np.quantile(sn, 0.01)), float(np.quantile(sn, 0.99))
    print(f"  s_noise: mean {out['s_noise_mean']:.4f}  R̂ {out['rhat']:.3f}  ESS {out['ess']:.0f}")
    check(out["s_noise_q01"] < NOISE_TRUE < out["s_noise_q99"],
          f"the noise's 1-99% posterior interval misses the truth: {out}")
    check(out["rhat"] < 1.2, f"R̂ {out['rhat']}")
    print("getting_started: OK")
    return out


if __name__ == "__main__":
    run_cli(main, __doc__)

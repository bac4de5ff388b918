"""The port's entry points: the flagship programme, the extended Mauna Loa
model, the pseudo-point programme, and the samplers' workloads (NUTS over GP
hyperparameters, SMC model evidence).

The flagship (counterpart of `__graft_entry__._flagship`):
`f1 = GP(v1·SE(·/l1))`, `f2 = GP(Matern32(·/l2))`, `f3 = f1 + f2`, with `f3`
observed under noise at x = linspace(-5, 5, n).

- `flagship(n, dtype, device)` returns `(step, theta)`; `step(theta)` is
  `(-logpdf, gradient in (v1, l1, l2, noise))` by `torch.autograd`.
- `predict(theta, x, y, xp)` conditions the programme on `f3` and returns
  the posterior marginals of `f1` at `xp`.

The extended Mauna Loa model (counterpart of `examples/extended_mauna_loa.py`,
built by `models.workloads.mauna_loa_style`): a shared trend under a CO₂-like
and a temperature-like output, observed jointly as `BlockData`:

- `mauna_loa_data(n_co2, n_T, dtype, device)`: the example's synthetic
  data (seed 0), `(x_co2, y_co2, x_T, y_T)`;
- `mauna_loa_spec(dtype, device)` and `obs_noise(t, n_co2, n_T)`: the
  example's constrained spec and per-output noise;
- `mauna_loa_step(theta, data)`: −logpdf over `BlockData(f_co2, f_T)` and
  its gradient in the flat θ of the spec's free leaves;
- `mauna_loa_fit(num_steps, ...)`: the example's Adam fit;
- `mauna_loa_posterior` and `mauna_loa_predict`: the joint posterior, and
  its marginals at `BlockData(f_co2, f_T, f_trend)`.

The pseudo-point programme (counterpart of
`examples/gppp_and_pseudo_points.py`, built by
`models.workloads.pseudo_points_model`): `f1 = v1·SE(·/l1)`,
`f2 = v2·Matern52(·/l2)`, `f3 = f1 + f2`, with `f3` observed under noise and
pseudo-points in both latents, `BlockData(f1 at z, f2 at z)`, trained by
the collapsed Titsias ELBO (VFE):

- `pseudo_points_data(n, m, dtype, device)`: x sorted uniform, a slow and a
  fast sinusoid under noise for y, and z, made with numpy from a seed;
- `pseudo_points_spec(z)`: the example's spec at its initial values, z
  unconstrained;
- `pseudo_points_neg_elbo(t, data)`, `pseudo_points_step(theta, data)`
  (value and gradient in the flat θ), `pseudo_points_fit` (Adam) and
  `pseudo_points_predict` (`posterior_vfe`, marginals of f1 and f3).

NUTS over GP hyperparameters (counterpart of `examples/nuts_hyperparameters.py`
and `scripts/nuts_bench.py`, BASELINE #5): `f = GP(v·SE(·/l))` observed under
noise, standard-normal priors on the unconstrained θ = log(l, noise, v):

- `nuts_data(n, dtype, device, seed)`: x sorted uniform on [−5, 5] and y a
  draw of 2·SE(·/1.3) under noise variance 0.1, made with numpy;
- `nuts_logdensity(data)`: `(logdensity, theta0, unflatten)`;
- `nuts_run(...)`: warmup and sampling over batched chains (`run_nuts`),
  with the draws mapped to the constrained (v, l, noise).

SMC model evidence (counterpart of `examples/smc_model_evidence.py`): data
from the SE model, and the SE and Matern32 models' log-likelihoods in
q = log(v, l, noise) (`smc_data`, `smc_loglike`, `smc_logprior`,
`SMC_BUILDS`, `smc_run`).

Everything runs on `cuda` unless the caller passes `device="cpu"`.  At
N ≥ 4096 on the card, an f32 factorisation takes the blocked path through
all three CUDA kernels (any other dtype takes it with the library's base
cases); on the CPU the same path runs under `config.chol_backend("blocked")`
with the kernels' plain versions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from stheno_tpu_torch import params as P
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.finite_gp import VFE, elbo, logpdf, marginals, posterior, posterior_vfe
from stheno_tpu_torch.gppp import gppp
from stheno_tpu_torch.graph import GP
from stheno_tpu_torch.inference import fit, run_nuts, run_smc
from stheno_tpu_torch.inputs import BlockData, GPPPInput
from stheno_tpu_torch.kernels import Matern32Kernel, SEKernel, with_lengthscale
from stheno_tpu_torch.models.workloads import (
    hyperparameter_model,
    mauna_loa_style,
    pseudo_points_model,
)

THETA = dict(v1=1.5, l1=1.0, l2=0.5, noise=0.1)


@gppp
def build(p):
    f1 = GP(p["v1"] * with_lengthscale(SEKernel(), p["l1"]))
    f2 = GP(with_lengthscale(Matern32Kernel(), p["l2"]))
    return dict(f1=f1, f2=f2, f3=f1 + f2)


def flagship_data(n=16384, m=1024, dtype=torch.float32, device="cuda"):
    """The flagship's inputs x (n,), targets y, prediction inputs xp (m,)
    and hyperparameters θ (0-d tensors), on `device`."""
    dev = resolve_device(device)
    x = torch.linspace(-5.0, 5.0, n, dtype=dtype, device=dev)
    y = torch.sin(x) + 0.2 * torch.cos(7 * x)
    xp = torch.linspace(-4.5, 4.5, m, dtype=dtype, device=dev)
    theta = {k: torch.tensor(v, dtype=dtype, device=dev) for k, v in THETA.items()}
    return x, y, xp, theta


def nlml(theta, x, y):
    """-log p(y | θ) of f3 observed at x under noise θ["noise"]."""
    f = build(theta)
    return -logpdf(f(GPPPInput("f3", x), theta["noise"]), y)


def flagship(n=16384, dtype=torch.float32, device="cuda"):
    """`(step, theta)`: `step(theta)` returns `(nlml, grad)` with `grad` a
    dict over θ's keys."""
    x, y, _, theta = flagship_data(n, 1, dtype, device)

    def step(theta):
        leaves = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
        val = nlml(leaves, x, y)
        grads = torch.autograd.grad(val, list(leaves.values()))
        return val.detach(), dict(zip(leaves, grads))

    return step, theta


def predict(theta, x, y, xp):
    """Posterior marginals (mean, var) of f1 at xp given f3 = y at x (the
    variance includes the default jitter of a noiseless FiniteGP)."""
    with torch.no_grad():
        f = build(theta)
        post = posterior(f(GPPPInput("f3", x), theta["noise"]), y)
        return post(GPPPInput("f1", xp)).mean_and_var()


# ---------------------------------------------------------------------------
# The extended Mauna Loa model
# ---------------------------------------------------------------------------

#: The model: a `@gppp` function of the constrained parameters.
build_gp = mauna_loa_style


def mauna_loa_data(n_co2=480, n_T=360, dtype=torch.float32, device="cuda"):
    """The example's `synthetic_data` with seed 0: CO₂-like (trend and
    seasonal) and temperature-like (trend) series, standardised, on yearly
    grids 1980–2020 and 1985–2020 shifted by 2000.  Returns
    `(x_co2, y_co2, x_T, y_T)` on `device`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    t_co2 = np.linspace(1980.0, 2020.0, n_co2)
    t_T = np.linspace(1985.0, 2020.0, n_T)
    co2 = (
        0.8 * (t_co2 - 2000.0) / 10.0
        + 0.05 * ((t_co2 - 2000.0) / 10.0) ** 2
        + 0.35 * np.sin(2 * np.pi * t_co2)
        + 0.12 * np.cos(4 * np.pi * t_co2)
        + 0.05 * rng.normal(size=n_co2)
    )
    temp = 0.6 * (t_T - 2000.0) / 10.0 + 0.3 * rng.normal(size=n_T)
    co2 = (co2 - co2.mean()) / co2.std()
    temp = (temp - temp.mean()) / temp.std()
    return tuple(torch.as_tensor(a, dtype=dtype, device=dev)
                 for a in (t_co2 - 2000.0, co2, t_T - 2000.0, temp))


def mauna_loa_spec(dtype=torch.float32, device="cuda"):
    """The example's constrained spec, its values as tensors of `dtype` on
    `device`."""
    dev = resolve_device(device)

    def pos(v):
        return P.positive(torch.tensor(v, dtype=dtype, device=dev))

    return dict(
        trend_scale=pos(0.1),
        co2=dict(s_latent=pos(0.3), s_wiggle=pos(0.3), l_wiggle=pos(5.0), s_period=pos(0.3),
                 freq=P.fixed(torch.tensor(1.0, dtype=dtype, device=dev)), s_noise=pos(0.1),
                 s_mean=pos(1.0)),
        temp=dict(s_trend=pos(1.0), s_wiggle=pos(1.0), l_wiggle=pos(0.5), s_noise=pos(0.1),
                  s_mean=pos(1.0)),
    )


def obs_noise(t, n_co2, n_T):
    """Per-point noise variances: s_noise² of each output over its block."""
    return torch.cat([(t["co2"]["s_noise"] ** 2).expand(n_co2),
                      (t["temp"]["s_noise"] ** 2).expand(n_T)])


def mauna_loa_observations(data):
    """`(BlockData(f_co2 at x_co2, f_T at x_T), y)`: the joint observation."""
    x_co2, y_co2, x_T, y_T = data
    return BlockData(GPPPInput("f_co2", x_co2), GPPPInput("f_T", x_T)), torch.cat([y_co2, y_T])


def mauna_loa_nlml(t, data):
    """−log p(y_co2, y_T | t): the joint marginal likelihood of both
    outputs under the constrained parameters `t`."""
    x, y = mauna_loa_observations(data)
    fx = build_gp(t)(x, obs_noise(t, len(data[0]), len(data[2])))
    return -logpdf(fx, y)


def mauna_loa_step(theta, data):
    """`(nlml, grad)` at the flat θ of the spec's free leaves (the spec in
    θ's dtype and on its device)."""
    _, unflatten = P.init(mauna_loa_spec(theta.dtype, theta.device))
    th = theta.detach().requires_grad_(True)
    val = mauna_loa_nlml(unflatten(th), data)
    (grad,) = torch.autograd.grad(val, th)
    return val.detach(), grad


def mauna_loa_fit(num_steps=250, learning_rate=3e-2, data=None, log_every=0,
                  dtype=torch.float32, device="cuda"):
    """The example's fit: Adam on the nlml from the spec's initial values
    (`data` defaults to the example's N = 840).  Returns `FitResult`."""
    if data is None:
        data = mauna_loa_data(dtype=dtype, device=device)
    spec = mauna_loa_spec(data[0].dtype, data[0].device)
    return fit(lambda t: mauna_loa_nlml(t, data), spec, num_steps=num_steps,
               learning_rate=learning_rate, log_every=log_every)


def mauna_loa_query(xp):
    """The joint query of CO₂, temperature and the shared trend at `xp`."""
    return BlockData(GPPPInput("f_co2", xp), GPPPInput("f_T", xp), GPPPInput("f_trend", xp))


def mauna_loa_posterior(params, data):
    """The joint posterior of the model given both outputs' observations."""
    x, y = mauna_loa_observations(data)
    return posterior(build_gp(params)(x, obs_noise(params, len(data[0]), len(data[2]))), y)


def mauna_loa_predict(params, data, xp=None, noise=None):
    """Posterior marginals at `mauna_loa_query(xp)` (`xp` defaults to the
    example's 200 points on [−22, 25]): a `Marginals` of length 3·len(xp),
    under `noise` (None: the dtype's default jitter)."""
    if xp is None:
        xp = torch.linspace(-22.0, 25.0, 200, dtype=data[0].dtype, device=data[0].device)
    with torch.no_grad():
        return marginals(mauna_loa_posterior(params, data)(mauna_loa_query(xp), noise))


# ---------------------------------------------------------------------------
# The pseudo-point programme (VFE with interdomain inducing points)
# ---------------------------------------------------------------------------

#: The model: a `@gppp` function of the constrained parameters.
build_pseudo_points = pseudo_points_model
#: The inducing points' noise (the example's).
PP_INDUCING_NOISE = 1e-6


def pseudo_points_data(n=131072, m=2048, dtype=torch.float32, device="cuda", seed=0,
                       half_width=1024.0):
    """`(x, y, z)` on `device`: x (n,) sorted uniform on [−w, w] with
    w = `half_width`, y = sin(x/2) + 0.3·sin(2.5x + 1) + √0.05·ε (a slow
    part on f1's scale and a fast part on f2's) and z = linspace(−w, w, m),
    the inducing inputs shared by both latents, made with numpy from `seed`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-half_width, half_width, n))
    y = np.sin(x / 2) + 0.3 * np.sin(2.5 * x + 1.0) + np.sqrt(0.05) * rng.normal(size=n)
    z = np.linspace(-half_width, half_width, m)
    return tuple(torch.as_tensor(a, dtype=dtype, device=dev) for a in (x, y, z))


def pseudo_points_spec(z):
    """The example's spec at its initial values, in z's dtype and on its
    device: v1 = v2 = 0.8, l1 = l2 = 1, noise 0.2, and the inducing inputs
    z unconstrained."""

    def pos(v):
        return P.positive(torch.tensor(v, dtype=z.dtype, device=z.device))

    return dict(v1=pos(0.8), l1=pos(1.0), v2=pos(0.8), l2=pos(1.0), noise=pos(0.2), z=z)


def pseudo_points_observations(t, x):
    """`(fx, u)`: f3 at x under noise t["noise"], and the pseudo-points
    `BlockData(f1 at t["z"], f2 at t["z"])`, both from one built programme."""
    f = build_pseudo_points(t)
    fx = f(GPPPInput("f3", x), t["noise"])
    u = f(BlockData(GPPPInput("f1", t["z"]), GPPPInput("f2", t["z"])), PP_INDUCING_NOISE)
    return fx, u


def pseudo_points_neg_elbo(t, data):
    """−ELBO of y under the constrained parameters `t` (`data` = (x, y, …))."""
    fx, u = pseudo_points_observations(t, data[0])
    return -elbo(VFE(u), fx, data[1])


def pseudo_points_step(theta, data):
    """`(−elbo, grad)` at the flat θ of the spec's free leaves (in the order
    l1, l2, noise, v1, v2, z)."""
    _, unflatten = P.init(pseudo_points_spec(data[2].to(theta.dtype)))
    th = theta.detach().requires_grad_(True)
    val = pseudo_points_neg_elbo(unflatten(th), data)
    (grad,) = torch.autograd.grad(val, th)
    return val.detach(), grad


def pseudo_points_fit(num_steps=400, learning_rate=2e-2, data=None, log_every=0,
                      dtype=torch.float32, device="cuda"):
    """The example's fit: Adam on the −ELBO from the spec's initial values,
    z included (`data` defaults to the full width, N = 131072 with 2048
    inducing inputs per latent).  Returns `FitResult`."""
    if data is None:
        data = pseudo_points_data(dtype=dtype, device=device)
    return fit(lambda t: pseudo_points_neg_elbo(t, data), pseudo_points_spec(data[2]),
               num_steps=num_steps, learning_rate=learning_rate, log_every=log_every)


def pseudo_points_query(xp):
    """The joint query of f1 and f3 at `xp`."""
    return BlockData(GPPPInput("f1", xp), GPPPInput("f3", xp))


def pseudo_points_predict(params, data, xp, noise=None):
    """The VFE approximate posterior's marginals at `pseudo_points_query(xp)`
    (f1, then f3), under `noise` (None: the dtype's default jitter)."""
    with torch.no_grad():
        fx, u = pseudo_points_observations(params, data[0])
        post = posterior_vfe(VFE(u), fx, data[1])
        return marginals(post(pseudo_points_query(xp), noise))


# ---------------------------------------------------------------------------
# NUTS over GP hyperparameters (BASELINE #5) and SMC model evidence
# ---------------------------------------------------------------------------

#: The NUTS model: f = GP(v·SE(·/l)), a `@gppp` function of (v, l).
build_hyperparameters = hyperparameter_model
#: The NUTS data's truth: signal variance, lengthscale, noise variance.
NUTS_TRUTH = dict(v=2.0, l=1.3, noise=0.1)
#: The SMC data's truth.
SMC_TRUTH = dict(v=1.5, l=1.2, noise=0.1)


def _se_draw(x, v, l, noise, rng):
    """y ~ N(0, v·SE(·/l) + noise·I) at x, in f64 with numpy."""
    d = (x[:, None] - x[None, :]) / l
    K = v * np.exp(-0.5 * d * d) + noise * np.eye(len(x))
    return np.linalg.cholesky(K) @ rng.normal(size=len(x))


def nuts_data(n=60, dtype=torch.float64, device="cuda", seed=1):
    """`(x, y)` on `device`: x (n,) sorted uniform on [−5, 5], y a draw of
    2·SE(·/1.3) under noise variance 0.1, made with numpy from `seed`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-5.0, 5.0, n))
    y = _se_draw(x, NUTS_TRUTH["v"], NUTS_TRUTH["l"], NUTS_TRUTH["noise"], rng)
    return tuple(torch.as_tensor(a, dtype=dtype, device=dev) for a in (x, y))


def nuts_spec(dtype=torch.float64, device="cuda"):
    """The example's spec: v, l, noise positive at 1.0, 1.0, 0.3."""
    dev = resolve_device(device)
    return {k: P.positive(torch.tensor(v, dtype=dtype, device=dev))
            for k, v in dict(v=1.0, l=1.0, noise=0.3).items()}


def nuts_logdensity(data):
    """`(logdensity, theta0, unflatten)` of the NUTS workload: logdensity(θ)
    = log p(y | v, l, noise) − ½‖θ‖², a standard-normal prior on the
    unconstrained θ (in sorted-key order: l, noise, v), the spec's θ0, and
    its map to the constrained values."""
    x, y = data
    theta0, unflatten = P.init(nuts_spec(x.dtype, x.device))

    def logdensity(theta):
        p = unflatten(theta)
        fx = build_hyperparameters(p)(GPPPInput("f", x), p["noise"])
        return logpdf(fx, y) - 0.5 * torch.sum(theta**2)

    return logdensity, theta0, unflatten


class NUTSRun(NamedTuple):
    theta: torch.Tensor  # (C, S, 3) unconstrained draws
    params: dict  # name -> (C, S) constrained draws
    info: object  # NUTSInfo of (C, S)
    state: object  # the final ChainState


def nuts_params(theta, unflatten):
    """The constrained draws {v, l, noise} of unconstrained draws (..., 3)."""
    flat = theta.reshape(-1, theta.shape[-1])
    vals = torch.func.vmap(unflatten)(flat)
    return {k: v.reshape(theta.shape[:-1]) for k, v in vals.items()}


def nuts_run(num_warmup=300, num_samples=400, num_chains=4, max_depth=10, n=60,
             dtype=torch.float64, device="cuda", seed=11, data=None, resume_state=None,
             sample_offset=0, check_rhat=True):
    """The example's run: `num_chains` chains of NUTS with Stan warmup over
    the posterior of (v, l, noise) given `data` (default `nuts_data(n)`);
    with `resume_state`, sampling only from it.  Returns `NUTSRun`."""
    if data is None:
        data = nuts_data(n, dtype, device)
    logdensity, theta0, unflatten = nuts_logdensity(data)
    theta, info, state = run_nuts(seed, logdensity, theta0, num_warmup=num_warmup,
                                  num_samples=num_samples, num_chains=num_chains,
                                  max_depth=max_depth, return_state=True,
                                  resume_state=resume_state, sample_offset=sample_offset,
                                  check_rhat=check_rhat)
    return NUTSRun(theta, nuts_params(theta, unflatten), info, state)


@gppp
def smc_build_m32(p):
    """The SMC example's alternative model: f = GP(v·Matern32(·/l))."""
    return dict(f=GP(p["v"] * with_lengthscale(Matern32Kernel(), p["l"])))


#: The SMC example's two models, by name.
SMC_BUILDS = {"SE": hyperparameter_model, "Matern32": smc_build_m32}


def smc_data(n=50, dtype=torch.float64, device="cuda", seed=3):
    """`(x, y)` on `device`: x (n,) sorted uniform on [−4, 4], y a draw of
    the SE model (v 1.5, l 1.2) under noise variance 0.1, numpy from `seed`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-4.0, 4.0, n))
    y = _se_draw(x, SMC_TRUTH["v"], SMC_TRUTH["l"], SMC_TRUTH["noise"], rng)
    return tuple(torch.as_tensor(a, dtype=dtype, device=dev) for a in (x, y))


def smc_loglike(build, data):
    """The log-likelihood of q = log(v, l, noise) under the model `build`."""
    x, y = data

    def loglike(q):
        p = dict(v=torch.exp(q[0]), l=torch.exp(q[1]), noise=torch.exp(q[2]))
        return logpdf(build(p)(GPPPInput("f", x), p["noise"]), y)

    return loglike


def smc_logprior(q):
    """Standard-normal prior on q (3,)."""
    return -0.5 * torch.sum(q**2) - 1.5 * math.log(2 * math.pi)


def smc_particles(num_particles=512, dtype=torch.float64, device="cuda", seed=1):
    """Prior draws (num_particles, 3), made with numpy from `seed`."""
    dev = resolve_device(device)
    draws = np.random.default_rng(seed).normal(size=(num_particles, 3))
    return torch.as_tensor(draws, dtype=dtype, device=dev)


def smc_run(build, data, num_particles=512, seed=5, num_mcmc=5, hmc_step_size=0.25,
            hmc_num_steps=10):
    """The example's run for one model: adaptive-tempering SMC from
    `num_particles` prior draws.  Returns `SMCResult`."""
    init = smc_particles(num_particles, data[0].dtype, data[0].device)
    return run_smc(seed, smc_loglike(build, data), smc_logprior, init, num_mcmc=num_mcmc,
                   hmc_step_size=hmc_step_size, hmc_num_steps=hmc_num_steps)

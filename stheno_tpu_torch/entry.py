"""The port's entry points: the flagship programme, the extended Mauna Loa
model, the pseudo-point programme, the samplers' workloads (NUTS over GP
hyperparameters, SMC model evidence), and derivative, convolution, NKN and
pathwise-sampling workloads.

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
  its marginals at `BlockData(f_co2, f_T, f_trend)`;
- `mauna_loa_example`: the example at its own size with its checks.

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
  `pseudo_points_predict` (`posterior_vfe`, marginals of f1 and f3);
- `pseudo_points_example`: the example at its own size with its checks.

NUTS over GP hyperparameters (counterpart of `examples/nuts_hyperparameters.py`
and `scripts/nuts_bench.py`, BASELINE #5): `f = GP(v·SE(·/l))` observed under
noise, standard-normal priors on the unconstrained θ = log(l, noise, v):

- `nuts_data(n, dtype, device, seed)`: x sorted uniform on [−5, 5] and y a
  draw of 2·SE(·/1.3) under noise variance 0.1, made with numpy;
- `nuts_logdensity(data)`: `(logdensity, theta0, unflatten)`;
- `nuts_run(...)`: warmup and sampling over batched chains (`run_nuts`),
  with the draws mapped to the constrained (v, l, noise);
- `nuts_example`: the example at its own size with its checks.

SMC model evidence (counterpart of `examples/smc_model_evidence.py`): data
from the SE model, and the SE and Matern32 models' log-likelihoods in
q = log(v, l, noise) (`smc_data`, `smc_loglike`, `smc_logprior`,
`SMC_BUILDS`, `smc_run`), and the example with its checks (`smc_example`).

Derivatives, convolutions, the NKN and pathwise sampling:

- the gradient-enhanced GP: `f = GP(v·SE(·/l))` with f and f′ observed
  jointly as `BlockData` (`derivative_data`, `derivative_step`: −logpdf
  and its gradient through the nested jvp of K_df,df, `derivative_predict`:
  the posterior of f, f′ and f″);
- `pathwise_samples`: Matheron-updated RFF draws of the flagship
  programme, evaluated on f1, f2 and f3;
- deconvolution: `f = GP(v·SE(·/l))` and its Gaussian-window convolution
  Cf on quadrature nodes, Cf observed (`deconvolution_data`, `_step`,
  `_predict`: the posterior of f and Cf);
- the NKN example's model, data, spec, step and run (`nkn_*`);
- the examples `differentiation.py` and `quadrature_convolution.py` at
  their own sizes with their own checks (`differentiation_example`,
  `quadrature_convolution_example`).

Everything runs on `cuda` unless the caller passes `device="cpu"`.  At
N ≥ 4096 on the card, an f32 factorisation takes the blocked path through
all three CUDA kernels (any other dtype takes it with the library's base
cases); on the CPU the same path runs under `config.chol_backend("blocked")`
with the kernels' plain versions.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from stheno_tpu_torch import params as P
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.finite_gp import (
    VFE,
    elbo,
    logpdf,
    marginals,
    posterior,
    posterior_vfe,
    rand,
)
from stheno_tpu_torch.gppp import gppp
from stheno_tpu_torch.graph import GP, GPC, convolve_quadrature, cross_cov, derivative
from stheno_tpu_torch.inference import (
    effective_sample_size,
    fit,
    potential_scale_reduction,
    run_nuts,
    run_smc,
)
from stheno_tpu_torch.inputs import BlockData, GPPPInput, split
from stheno_tpu_torch.kernels import (
    LinearKernel,
    LinearLayer,
    Matern32Kernel,
    NeuralKernelNetwork,
    PeriodicKernel,
    ProductLayer,
    RationalQuadraticKernel,
    SEKernel,
    with_lengthscale,
)
from stheno_tpu_torch.models.workloads import (
    hyperparameter_model,
    mauna_loa_style,
    pseudo_points_model,
)
from stheno_tpu_torch.sampling import pathwise_conditioned_samples
from stheno_tpu_torch.utils import logging as _trace

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
    variance includes the default jitter of a noiseless FiniteGP).  One
    `entry.predict` span, so the verbs of a request share its trace id."""
    with torch.no_grad(), _trace.span("entry.predict"):
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


def mauna_loa_example(num_steps=250, learning_rate=3e-2, dtype=torch.float64, device="cuda"):
    """`examples/extended_mauna_loa.py` at its own size (N = 840) with its
    own checks: the Adam fit gains more than 50 nats, the joint posterior's
    means at 3 × 200 points are finite and the in-sample CO₂ RMSE is below
    0.3.  In f64, as the example, the posterior is queried under its 1e-9;
    in f32 under the dtype's default jitter, 1e-9 being below f32's
    rounding.  Returns its numbers."""
    data = mauna_loa_data(dtype=dtype, device=device)
    t0 = time.perf_counter()
    res = mauna_loa_fit(num_steps, learning_rate, data=data)  # its losses come to the host
    out = {"n": len(data[1]) + len(data[3]), "steps": num_steps, "fit_s": time.perf_counter() - t0,
           "nlml_first": res.losses[0].item(), "nlml_last": res.losses[-1].item()}
    noise = 1e-9 if dtype == torch.float64 else None
    ms = mauna_loa_predict(res.params, data, noise=noise)
    with torch.no_grad():
        post = mauna_loa_posterior(res.params, data)
        m_in = marginals(post(GPPPInput("f_co2", data[0]), noise)).mean
    out["co2_in_sample_rmse"] = torch.sqrt(torch.mean((m_in - data[1]) ** 2)).item()
    _check(out["nlml_last"] < out["nlml_first"] - 50, f"the fit made no progress: {out}")
    _check(bool(torch.isfinite(ms.mean).all()), "the posterior means are not finite")
    _check(out["co2_in_sample_rmse"] < 0.3, f"in-sample CO2 rmse {out['co2_in_sample_rmse']}")
    return out


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


def pseudo_points_example(num_steps=400, learning_rate=2e-2, dtype=torch.float64, device="cuda"):
    """`examples/gppp_and_pseudo_points.py` at its own size (N = 600, 24
    inducing inputs per latent on [−8, 8], data seed 7) with its own
    checks: the −ELBO falls, the final ELBO lies below the exact logpdf and
    within 20 % (+50) of it, and the VFE posterior mean of f3 at 100 points
    follows the data to an RMSE below 0.35.  Returns its numbers."""
    data = pseudo_points_data(600, 24, dtype, device, seed=7, half_width=8.0)
    t0 = time.perf_counter()
    res = pseudo_points_fit(num_steps, learning_rate, data=data)
    out = {"n": len(data[0]), "m_per_latent": len(data[2]), "steps": num_steps,
           "fit_s": time.perf_counter() - t0, "neg_elbo_first": res.losses[0].item(),
           "neg_elbo_last": res.losses[-1].item()}
    with torch.no_grad():
        fx, u = pseudo_points_observations(res.params, data[0])
        out["final_elbo"] = elbo(VFE(u), fx, data[1]).item()
        out["exact_logpdf"] = logpdf(fx, data[1]).item()
    xp = torch.linspace(-8.0, 8.0, 100, dtype=dtype, device=data[0].device)
    _, m3 = split(pseudo_points_query(xp), pseudo_points_predict(res.params, data, xp, 1e-9).mean)
    xs, ys = data[0].cpu().numpy(), data[1].cpu().numpy()
    out["f3_rmse_vs_data"] = float(np.sqrt(np.mean(
        (np.interp(xs, xp.cpu().numpy(), m3.cpu().numpy()) - ys) ** 2)))
    _check(out["neg_elbo_last"] < out["neg_elbo_first"], f"the loss did not fall: {out}")
    _check(out["final_elbo"] <= out["exact_logpdf"], f"the ELBO exceeds the logpdf: {out}")
    _check(out["final_elbo"] > out["exact_logpdf"] - 0.2 * abs(out["exact_logpdf"]) - 50,
           f"the ELBO is far below the logpdf: {out}")
    _check(out["f3_rmse_vs_data"] < 0.35, f"f3 rmse {out['f3_rmse_vs_data']}")
    return out


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


def nuts_example(num_warmup=300, num_samples=400, num_chains=4, n=60, seed=11, device="cuda"):
    """`examples/nuts_hyperparameters.py` at its own size (N = 60, f64,
    4 chains of 300 + 400) with its own checks: the true l and noise inside
    the pooled 2–98 % quantiles and fewer than 5 % divergences, and besides
    a split-R̂ of at most 1.05.  Returns its numbers, the run under "run"."""
    data = nuts_data(n, torch.float64, device)
    t0 = time.perf_counter()
    ex = nuts_run(num_warmup, num_samples, num_chains, data=data, seed=seed)
    post = {k: v.cpu().numpy().ravel() for k, v in ex.params.items()}  # to the host: synced
    out = {"n": n, "chains": num_chains, "warmup": num_warmup, "samples": num_samples,
           "seconds": time.perf_counter() - t0,
           "ess": [effective_sample_size(ex.theta[..., i]).item() for i in range(3)],
           "rhat_max": potential_scale_reduction(ex.theta).max().item(),
           "divergence_rate": ex.info.diverging.double().mean().item(),
           "accept_prob": ex.info.accept_prob.mean().item(),
           "evals_per_transition": ex.info.num_evals.double().mean().item(),
           "means": {k: float(v.mean()) for k, v in post.items()},
           "q02_q98": {k: np.quantile(v, [0.02, 0.98]).tolist() for k, v in post.items()}}
    out["ess_per_s"] = sum(out["ess"]) / out["seconds"]
    for k in ("l", "noise"):
        lo, hi = out["q02_q98"][k]
        _check(lo < NUTS_TRUTH[k] < hi, f"the true {k} lies outside the 2-98% quantiles")
    _check(out["divergence_rate"] < 0.05, f"divergence rate {out['divergence_rate']}")
    _check(out["rhat_max"] <= 1.05, f"max split-R-hat {out['rhat_max']}")
    out["run"] = ex
    return out


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


def smc_example(num_particles=512, device="cuda"):
    """`examples/smc_model_evidence.py` at its own size (N = 50, f64) with
    its own checks: the SE and Matern32 models' evidence by SMC from
    `num_particles` particles favours the generating SE model, whose
    posterior median l lies in (0.4, 3.5) and noise below 0.5.  Returns
    each model's numbers, the runs under "results"."""
    data = smc_data(50, torch.float64, device)
    out = {"results": {}}
    for name, build in SMC_BUILDS.items():
        t0 = time.perf_counter()
        res = smc_run(build, data, num_particles=num_particles)
        med = np.median(np.exp(res.particles.cpu().numpy()), axis=0)
        out[name] = {"log_evidence": res.log_evidence.item(), "stages": int(res.num_stages),
                     "seconds": time.perf_counter() - t0, "median_v_l_noise": med.tolist()}
        out["results"][name] = res
    _check(out["SE"]["log_evidence"] > out["Matern32"]["log_evidence"],
           "the evidence does not favour the generating model (SE)")
    med = out["SE"]["median_v_l_noise"]
    _check(0.4 < med[1] < 3.5, f"median l {med[1]} outside (0.4, 3.5)")
    _check(med[2] < 0.5, f"median noise {med[2]} >= 0.5")
    return out


# ---------------------------------------------------------------------------
# Derivative and convolved processes, the NKN and pathwise sampling
# ---------------------------------------------------------------------------

#: The gradient-enhanced GP's truth-free starting point: f = GP(v·SE(·/l)),
#: both f and f′ observed under noise variance `noise`.
DERIVATIVE_THETA = dict(v=1.0, l=1.0, noise=0.01)


def _theta(values, dtype, device):
    return {k: torch.tensor(v, dtype=dtype, device=device) for k, v in values.items()}


@gppp
def build_derivative(p):
    """f = GP(v·SE(·/l)), its derivative df and its second derivative ddf."""
    f = GP(p["v"] * with_lengthscale(SEKernel(), p["l"]))
    df = derivative(f)
    return dict(f=f, df=df, ddf=derivative(df))


def _test_function(x):
    """g(x) = sin(1.3x) + 0.5·cos(0.7x) and its exact derivative."""
    return (np.sin(1.3 * x) + 0.5 * np.cos(0.7 * x),
            1.3 * np.cos(1.3 * x) - 0.35 * np.sin(0.7 * x))


def derivative_data(n=16384, m=1024, dtype=torch.float32, device="cuda", seed=0):
    """The gradient-enhanced GP's data on `device`: `(xf, xd, y, xp, theta)`
    with xf and xd (n/2 each) sorted uniform on [−5, 5], y the test
    function g at xf then g′ at xd under noise of standard deviation 0.1,
    made with numpy from `seed`, xp = linspace(−4.5, 4.5, m), and θ
    (`DERIVATIVE_THETA`, 0-d tensors)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    xf = np.sort(rng.uniform(-5.0, 5.0, n // 2))
    xd = np.sort(rng.uniform(-5.0, 5.0, n - n // 2))
    y = np.concatenate([_test_function(xf)[0], _test_function(xd)[1]]) + 0.1 * rng.normal(size=n)
    xp = np.linspace(-4.5, 4.5, m)
    xf, xd, y, xp = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (xf, xd, y, xp))
    return xf, xd, y, xp, _theta(DERIVATIVE_THETA, dtype, dev)


def derivative_observation(theta, data):
    """`fx`: f at xf and f′ at xd jointly, `BlockData(f, df)`, under noise."""
    xf, xd = data[:2]
    f = build_derivative(theta)
    return f(BlockData(GPPPInput("f", xf), GPPPInput("df", xd)), theta["noise"])


def derivative_step(theta, data):
    """`(−logpdf, gradient in θ)` of the joint observation of f and f′: the
    covariance's blocks K_ff (kernel 1), K_f,df and K_df,f (one jvp each)
    and K_df,df (a nested jvp), then the factor (blocked at N ≥ 4096 on
    the card)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
    val = -logpdf(derivative_observation(leaves, data), data[2])
    grads = torch.autograd.grad(val, list(leaves.values()))
    return val.detach(), dict(zip(leaves, grads))


def derivative_query(xp):
    """The joint query of f, f′ and f″ at `xp`."""
    return BlockData(GPPPInput("f", xp), GPPPInput("df", xp), GPPPInput("ddf", xp))


def derivative_predict(theta, data, noise=None):
    """Posterior marginals of f, f′ and f″ at xp given the joint
    observation (a `Marginals` of length 3·len(xp)), under `noise`."""
    with torch.no_grad():
        post = posterior(derivative_observation(theta, data), data[2])
        return marginals(post(derivative_query(data[3]), noise))


def pathwise_samples(theta, x, y, xp, num_samples=64, num_features=1024, seed=0):
    """Pathwise posterior samples of the flagship programme given f3 = y at
    x: S draws with F features a leaf, evaluated on f1, f2 and f3 at xp.
    Returns `{"f1": (S, M), "f2": ..., "f3": ...}`."""
    with torch.no_grad():
        fx = build(theta)(GPPPInput("f3", x), theta["noise"])
        draws = pathwise_conditioned_samples(fx, y, seed, num_samples, num_features)
        q = BlockData(GPPPInput("f1", xp), GPPPInput("f2", xp), GPPPInput("f3", xp))
        vals = draws(q)
        m = xp.shape[0]
        return {k: vals[:, i * m:(i + 1) * m] for i, k in enumerate(("f1", "f2", "f3"))}


def gaussian_window(width):
    """The Gaussian smoothing window w(x, τ) of standard deviation `width`."""

    def w(x, tau):
        d = (x[:, None] - tau[None, :]) / width
        return torch.exp(-0.5 * d * d) / (width * math.sqrt(2.0 * math.pi))

    return w


#: The deconvolution model's window width and hyperparameters.
DECONV_WIDTH = 0.5
DECONV_THETA = dict(v=1.0, l=0.4, noise=0.01)


@gppp
def build_deconvolution(p):
    """f = GP(v·SE(·/l)) and Cf, its convolution with a Gaussian window of
    width 0.5 by quadrature on the nodes `p["nodes"]`."""
    f = GP(p["v"] * with_lengthscale(SEKernel(), p["l"]))
    return dict(f=f, Cf=convolve_quadrature(f, gaussian_window(DECONV_WIDTH), p["nodes"]))


def deconvolution_data(n=16384, m=1024, q=2048, dtype=torch.float32, device="cuda", seed=0):
    """`(x, y, xp, theta)` on `device`: x (n,) sorted uniform on [−4, 4], y
    the window's exact smoothing of g(t) = sin(2t) + 0.5·sin(5t + 1) under
    noise of standard deviation 0.1 (numpy, from `seed`), xp =
    linspace(−3.5, 3.5, m), and θ (`DECONV_THETA`) with the q quadrature
    nodes on [−6, 6] as θ["nodes"]."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-4.0, 4.0, n))
    s2 = DECONV_WIDTH**2
    y = (np.exp(-2.0 * s2) * np.sin(2 * x) + 0.5 * np.exp(-12.5 * s2) * np.sin(5 * x + 1.0)
         + 0.1 * rng.normal(size=n))
    xp = np.linspace(-3.5, 3.5, m)
    theta = _theta(DECONV_THETA, dtype, dev)
    theta["nodes"] = torch.linspace(-6.0, 6.0, q, dtype=dtype, device=dev)
    return (*(torch.as_tensor(a, dtype=dtype, device=dev) for a in (x, y, xp)), theta)


def deconvolution_step(theta, data):
    """`(−logpdf, gradient in v, l, noise)` of Cf observed at x: W·K·Wᵀ with
    K on the nodes from kernel 1 and the products on `torch.matmul`."""
    x, y = data[:2]
    leaves = {k: (v if k == "nodes" else v.detach().requires_grad_(True))
              for k, v in theta.items()}
    val = -logpdf(build_deconvolution(leaves)(GPPPInput("Cf", x), leaves["noise"]), y)
    keys = [k for k in leaves if k != "nodes"]
    grads = torch.autograd.grad(val, [leaves[k] for k in keys])
    return val.detach(), dict(zip(keys, grads))


def deconvolution_predict(theta, data, noise=None):
    """Posterior marginals of the latent f and of Cf at xp given Cf at x
    (a `Marginals` of length 2·len(xp))."""
    x, y, xp = data[:3]
    with torch.no_grad():
        g = build_deconvolution(theta)
        post = posterior(g(GPPPInput("Cf", x), theta["noise"]), y)
        return marginals(post(BlockData(GPPPInput("f", xp), GPPPInput("Cf", xp)), noise))


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"example check failed: {msg}")


def differentiation_example(device="cuda"):
    """`examples/differentiation.py` at its own size in f64 with its own
    checks: closed-form SE derivative covariances, then f observed at 50
    points and f′, f″ read off.  Returns its numbers.

    The observations are a prior draw, from a `torch.Generator` seeded 0:
    the reference's draw (JAX key 4) cannot be reproduced, and torch's
    seed 4 draws a path that rises across the whole window, where the
    example's check at the peak of the posterior mean has no peak to test."""
    dev = resolve_device(device)
    f64 = torch.float64

    @gppp
    def model():
        f = GP(SEKernel())
        df = derivative(f)
        return dict(f=f, df=df, ddf=derivative(df))

    g = model()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=6), dtype=f64, device=dev)
    y = torch.as_tensor(rng.normal(size=8), dtype=f64, device=dev)
    d = x[:, None] - y[None, :]
    k = torch.exp(-0.5 * d * d)
    errs = {
        "cov_df_f": (cross_cov(g["df"], g["f"], x, y) + d * k).abs().max().item(),
        "cov_df_df": (g["df"].cov2(x, y) - (1 - d * d) * k).abs().max().item(),
        "cov_ddf_ddf": (g["ddf"].cov2(x, y) - (3 - 6 * d**2 + d**4) * k).abs().max().item(),
    }
    _check(errs["cov_df_f"] < 1e-10 and errs["cov_df_df"] < 1e-10 and errs["cov_ddf_ddf"] < 1e-9,
           f"closed-form SE derivative covariances {errs}")

    xo = torch.linspace(-3.0, 3.0, 50, dtype=f64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    yo = rand(gen, g(GPPPInput("f", xo), 1e-6))
    post = posterior(g(GPPPInput("f", xo), 1e-6), yo)
    xp = torch.linspace(-2.5, 2.5, 101, dtype=f64, device=dev)
    q = derivative_query(xp)
    ms = marginals(post(q, 1e-9))
    mf, mdf, mddf = split(q, ms.mean)
    eps = 1e-4
    fd = (post.mean(GPPPInput("f", xp + eps)) - post.mean(GPPPInput("f", xp - eps))) / (2 * eps)
    errs["mean_df_vs_fd"] = (mdf - fd).abs().max().item()
    _check(errs["mean_df_vs_fd"] < 1e-5, f"|E[f'] - d/dx E[f]| = {errs['mean_df_vs_fd']}")
    imax = int(torch.argmax(mf[10:-10])) + 10
    errs["df_at_peak"], errs["ddf_at_peak"] = mdf[imax].item(), mddf[imax].item()
    _check(abs(errs["df_at_peak"]) < 0.2, "the derivative should vanish at the peak")
    _check(errs["ddf_at_peak"] < 0.1, "the curvature should be negative-ish at the peak")
    return errs


def quadrature_convolution_example(device="cuda"):
    """`examples/quadrature_convolution.py` at its own size in f64 with its
    own checks: the analytic Gaussian-convolution covariance, then
    deconvolution from 60 observations of Cf.  Returns its numbers."""
    dev = resolve_device(device)
    f64 = torch.float64

    @gppp
    def model():
        f = GP(with_lengthscale(SEKernel(), 0.4))
        nodes = torch.linspace(-6.0, 6.0, 241, dtype=f64, device=dev)
        return dict(f=f, Cf=convolve_quadrature(f, gaussian_window(0.5), nodes))

    g = model()
    rng = np.random.default_rng(8)
    x = torch.linspace(-2.0, 2.0, 9, dtype=f64, device=dev)
    l, sw = 0.4, 0.5
    l_eff = math.sqrt(l**2 + 2 * sw**2)
    d = x[:, None] - x[None, :]
    K_true = (l / l_eff) * torch.exp(-0.5 * (d / l_eff) ** 2)
    out = {"cov_err": (g["Cf"].cov(x) - K_true).abs().max().item()}
    _check(out["cov_err"] < 5e-4, f"|cov(Cf) - analytic| = {out['cov_err']}")

    xo = torch.as_tensor(np.sort(rng.uniform(-3, 3, 60)), dtype=f64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    yo = rand(gen, g(GPPPInput("Cf", xo), 1e-4))
    post = posterior(g(GPPPInput("Cf", xo), 1e-4), yo)
    xp = torch.linspace(-2.5, 2.5, 101, dtype=f64, device=dev)
    q = BlockData(GPPPInput("f", xp), GPPPInput("Cf", xp))
    ms = marginals(post(q, 1e-9))
    m_f, m_cf = split(q, ms.mean)
    v_f, v_cf = split(q, ms.var)
    _check(bool(torch.isfinite(ms.mean).all()), "non-finite posterior mean")
    out["var_f"], out["var_cf"] = v_f.mean().item(), v_cf.mean().item()
    _check(out["var_f"] > out["var_cf"], "the latent should be less identified than Cf")

    def curv(m):
        return torch.diff(m, n=2).abs().mean().item()

    out["curv_f"], out["curv_cf"] = curv(m_f), curv(m_cf)
    _check(out["curv_cf"] < out["curv_f"], "the smoothed mean should be smoother")
    return out


# The Neural Kernel Network (examples/neural_kernel_network.py)


def nkn_data(n=144, dtype=torch.float64, device="cuda", seed=4):
    """The example's airline-style series (trend × yearly seasonality, with
    multiplicative noise, numpy from `seed`) at n points over 12 years
    (monthly at n = 144), standardised by its first three quarters (the
    training years): `(x, y, n_train, period)` on `device`, `period` one
    year in the standardised units."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    t = np.arange(n) * (12.0 / n)
    season = 1.0 + 0.22 * np.sin(2 * np.pi * t - 0.7) + 0.08 * np.sin(4 * np.pi * t + 0.4)
    trend = 110.0 + 26.0 * t + 0.8 * t**2
    y_raw = trend * season * np.exp(0.02 * rng.normal(size=n))
    n_train = (3 * n) // 4
    xm, xs = t[:n_train].mean(), t[:n_train].std()
    ym, ys = y_raw[:n_train].mean(), y_raw[:n_train].std()
    x, y = (t - xm) / xs, (y_raw - ym) / ys
    x, y = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (x, y))
    return x, y, n_train, float(1.0 / xs)


def nkn_primitives(p):
    """The example's 8 primitive kernels: linear, periodic, SE and RQ at two
    scales each."""
    return (
        with_lengthscale(LinearKernel(), p["l_lin1"]),
        with_lengthscale(PeriodicKernel(r=p["r_per1"]), p["p_per1"]),
        with_lengthscale(SEKernel(), p["l_se1"]),
        with_lengthscale(RationalQuadraticKernel(alpha=p["a_rq1"]), p["l_rq1"]),
        with_lengthscale(LinearKernel(), p["l_lin2"]),
        with_lengthscale(RationalQuadraticKernel(alpha=p["a_rq2"]), p["l_rq2"]),
        with_lengthscale(SEKernel(), p["l_se2"]),
        with_lengthscale(PeriodicKernel(r=p["r_per2"]), p["p_per2"]),
    )


def nkn_spec(x_train, period, seed=0):
    """The example's spec in x's dtype and on its device: the primitives'
    hyperparameters positive, the periods `period`, lengthscales from the
    median pairwise distance of the training inputs (the reference's
    heuristic), the layers 8 → 8 → ×2 → 4 → ×2 → 1 with raw log-weights
    from a `torch.Generator` seeded `seed`, and the noise positive (lower
    bound 1e-4)."""
    dt, dev = x_train.dtype, x_train.device
    xs = x_train.detach().cpu().numpy()
    dists = np.abs(np.subtract.outer(xs, xs))[np.triu_indices(len(xs), 1)]
    l = float(np.median(dists))  # noqa: E741
    gen = torch.Generator(device=dev).manual_seed(seed)

    def pos(v, lb=0.0):
        return P.positive(torch.tensor(v, dtype=dt, device=dev), lb=lb)

    layers = (LinearLayer.init(gen, 8, 8, dtype=dt), ProductLayer(),
              LinearLayer.init(gen, 4, 4, dtype=dt), ProductLayer(),
              LinearLayer.init(gen, 2, 1, dtype=dt))
    return dict(
        l_lin1=pos(1.0), l_lin2=pos(3.0), p_per1=pos(period), r_per1=pos(1.0),
        p_per2=pos(period), r_per2=pos(0.7), l_se1=pos(l / 4.0), l_se2=pos(l),
        a_rq1=pos(0.2), l_rq1=pos(2.0 * l), a_rq2=pos(0.1), l_rq2=pos(l),
        layers=layers, noise=pos(0.1, lb=1e-4),
    )


@gppp
def build_nkn(p):
    """f = GP(NKN(the 8 primitives, p["layers"]))."""
    return dict(f=GP(NeuralKernelNetwork(nkn_primitives(p), tuple(p["layers"]))))


def nkn_nlml(p, x, y):
    """−log p(y | p) of f at x under noise p["noise"]."""
    return -logpdf(build_nkn(p)(GPPPInput("f", x), p["noise"]), y)


def nkn_step(theta, x, y, spec):
    """`(nlml, grad)` at the flat θ of the spec's free leaves (the
    primitives' raw hyperparameters, the layers' log-weights, the noise)."""
    _, unflatten = P.init(spec)
    th = theta.detach().requires_grad_(True)
    val = nkn_nlml(unflatten(th), x, y)
    (grad,) = torch.autograd.grad(val, th)
    return val.detach(), grad


def nkn_example(num_steps=120, learning_rate=2e-2, dtype=torch.float64, device="cuda"):
    """The example's run (`--fast`: 120 Adam steps) with its checks: the
    loss falls, the training RMSE is below 0.25 and the 3-year
    extrapolation beats a linear-trend baseline.  Returns its numbers."""
    x, y, n_train, period = nkn_data(dtype=dtype, device=device)
    xtr, ytr, xte, yte = x[:n_train], y[:n_train], x[n_train:], y[n_train:]
    res = fit(lambda p: nkn_nlml(p, xtr, ytr), nkn_spec(xtr, period), num_steps=num_steps,
              learning_rate=learning_rate)
    p = res.params
    with torch.no_grad():
        post = posterior(build_nkn(p)(GPPPInput("f", xtr), p["noise"]), ytr)
        mean = marginals(post(GPPPInput("f", x), 1e-8)).mean
        A = torch.stack([xtr, torch.ones_like(xtr)], dim=1)
        coef = torch.linalg.lstsq(A, ytr[:, None]).solution[:, 0]
    out = {
        "loss_first": res.losses[0].item(), "loss_last": res.losses[-1].item(),
        "rmse_train": torch.sqrt(torch.mean((mean[:n_train] - ytr) ** 2)).item(),
        "rmse_test": torch.sqrt(torch.mean((mean[n_train:] - yte) ** 2)).item(),
        "rmse_linear": torch.sqrt(torch.mean((coef[0] * xte + coef[1] - yte) ** 2)).item(),
    }
    _check(out["loss_last"] < out["loss_first"], f"the loss did not fall: {out}")
    _check(out["rmse_train"] < 0.25, f"training RMSE {out['rmse_train']}")
    _check(out["rmse_test"] < out["rmse_linear"], f"extrapolation no better than linear: {out}")
    return out


# ---------------------------------------------------------------------------
# The distributed tier (parallel/): the three examples that run it, on any
# mesh (a one-rank group on the card, gloo ranks on the CPU)
# ---------------------------------------------------------------------------


@gppp
def big_n_build(t):
    """The sharded examples' programme: f3 = v·SE(·/l) + Matern32."""
    f1 = GP(t["v"] * with_lengthscale(SEKernel(), t["l"]))
    f2 = GP(Matern32Kernel())
    return dict(f1=f1, f2=f2, f3=f1 + f2)


def _mesh_for(mesh, dev, axis="rows"):
    from stheno_tpu_torch.parallel.multihost import global_mesh

    return mesh if mesh is not None else global_mesh((axis,), device_type=dev.type)


def _whole(mesh, t, axis="rows"):
    """A tensor's rank slabs gathered in rank order."""
    from stheno_tpu_torch.parallel.collectives import Axis, all_gather

    return all_gather(t, Axis(mesh, axis))


def big_n_sharded_nlml(mesh, x, y, log_l, log_noise, block_size):
    """−`big_gp_logpdf` of GP(SE(·/exp(log_l))) under noise exp(log_noise)."""
    from stheno_tpu_torch.parallel import big_gp_logpdf

    k = with_lengthscale(SEKernel(), torch.exp(log_l))
    return -big_gp_logpdf(mesh, k, x, y, torch.exp(log_noise), block_size=block_size)


def big_n_sharded_example(fast=True, n_gppp=None, mesh=None, device="cuda"):
    """`examples/big_n_sharded.py` on the ranks of `mesh` (a 'rows' mesh of
    the job by default), in f64, with the example's own checks: the
    distributed nlml and gradient against the dense logpdf, 10 (fast) or
    25 normalised gradient steps recovering the lengthscale, then the
    composite programme sharded (`sharded_rand`, `sharded_logpdf`,
    `sharded_posterior` of f1 given f3 at N = `n_gppp`) and against the
    dense path at N = 512.  The data is a numpy draw from seed 0 (the
    reference's JAX key cannot be reproduced).  Returns its numbers."""
    from stheno_tpu_torch.parallel import sharded_logpdf, sharded_posterior, sharded_rand

    dev = resolve_device(device)
    mesh = _mesh_for(mesh, dev)
    f64 = torch.float64
    n, B = (512, 64) if fast else (2048, 128)
    rng = np.random.default_rng(0)
    xn = np.sort(rng.uniform(-10, 10, n))
    yn = _se_draw(xn, 1.0, 1.0, 0.1, rng)
    x, y = (torch.as_tensor(a, dtype=f64, device=dev) for a in (xn, yn))
    out = {}

    def value_and_grad(ll, ln):
        ll = torch.as_tensor(ll, dtype=f64, device=dev).requires_grad_(True)
        ln = torch.as_tensor(ln, dtype=f64, device=dev).requires_grad_(True)
        v = big_n_sharded_nlml(mesh, x, y, ll, ln, B)
        gl, gn = torch.autograd.grad(v, (ll, ln))
        return v.detach(), gl, gn

    val, gl, gn = value_and_grad(0.0, math.log(0.1))
    with torch.no_grad():
        f = GP(with_lengthscale(SEKernel(), 1.0), gpc=GPC())
        lp_ref = logpdf(f(x, 0.1), y)
    out.update(nlml=val.item(), grad=(gl.item(), gn.item()), err=abs(val.item() + lp_ref.item()))
    _check(out["err"] < 1e-6, f"|distributed - dense| = {out['err']}")
    ll, ln = torch.tensor(0.3, dtype=f64), torch.tensor(math.log(0.3), dtype=f64)
    steps = 10 if fast else 25
    for _ in range(steps):
        _, gl, gn = value_and_grad(ll, ln)
        norm = torch.clamp(torch.sqrt(gl**2 + gn**2), min=1.0).cpu()
        ll, ln = ll - 0.05 * gl.cpu() / norm, ln - 0.05 * gn.cpu() / norm
    out.update(l=math.exp(ll.item()), noise=math.exp(ln.item()), gd_steps=steps)
    _check(0.5 < out["l"] < 2.0, f"lengthscale {out['l']} after {steps} distributed steps")

    # the composite programme, sharded
    theta = {k: torch.tensor(v, dtype=f64, device=dev) for k, v in dict(v=1.5, l=1.0).items()}
    ng = n_gppp if n_gppp is not None else (1024 if fast else 4096)
    xg = torch.linspace(-10.0, 10.0, ng, dtype=f64, device=dev)
    xp = torch.linspace(-8.0, 8.0, 256, dtype=f64, device=dev)
    bg = max(B, ng // 32)
    with torch.no_grad():
        fxg = big_n_build(theta)(GPPPInput("f3", xg), 0.1)
        gen = torch.Generator(device=dev).manual_seed(1)
        yg = _whole(mesh, sharded_rand(gen, mesh, fxg, block_size=bg))
        out["gppp_logpdf"] = sharded_logpdf(mesh, fxg, yg, block_size=bg).item()
        m1, v1 = sharded_posterior(mesh, fxg, yg, block_size=bg).mean_and_var(GPPPInput("f1", xp))
        _check(bool(torch.isfinite(m1).all() and (v1 > 0).all()), "non-finite sharded posterior")
        out["gppp_n"] = ng
        # exactness against the dense path at N = 512
        xd = torch.linspace(-10.0, 10.0, 512, dtype=f64, device=dev)
        fxd = big_n_build(theta)(GPPPInput("f3", xd), 0.1)
        yd = rand(torch.Generator(device=dev).manual_seed(2), fxd)
        post_sh = sharded_posterior(mesh, fxd, yd, block_size=64)
        m_sh, v_sh = post_sh.mean_and_var(GPPPInput("f1", xp))
        post_d = posterior(fxd, yd)
        m_d, v_d = post_d.mean_and_var(GPPPInput("f1", xp))
        out["err_lp"] = abs(sharded_logpdf(mesh, fxd, yd, block_size=64).item() - logpdf(fxd, yd).item())
        out["err_m"] = (m_sh - m_d).abs().max().item()
        out["err_v"] = (v_sh - v_d).abs().max().item()
    _check(out["err_lp"] < 1e-6 and out["err_m"] < 1e-8 and out["err_v"] < 1e-8,
           f"sharded vs dense: {out['err_lp']}, {out['err_m']}, {out['err_v']}")
    return out


def matrix_free_data(n, dtype=torch.float64, device="cuda", seed=3):
    """`examples/matrix_free_big_n.py`'s data: x sorted uniform on [−8, 8]
    and y a draw of 1.5·SE(·/0.7) under noise variance 0.1 (numpy)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-8, 8, n))
    y = _se_draw(x, 1.5, 0.7, 0.1, rng)
    return tuple(torch.as_tensor(a, dtype=dtype, device=dev) for a in (x, y))


def matrix_free_nlml(mesh, x_sh, y_sh, logp, generator, **ring):
    """−`ring_gp_logpdf` of v·SE(·/l) under noise s, (v, l, s) = exp(logp),
    on each rank's shard."""
    from stheno_tpu_torch.parallel.ring import ring_gp_logpdf

    v, l, s = torch.exp(logp)
    k = v * with_lengthscale(SEKernel(), l)
    return -ring_gp_logpdf(mesh, k, x_sh, y_sh, s, generator, **ring)


def matrix_free_example(fast=True, mesh=None, device="cuda"):
    """`examples/matrix_free_big_n.py` on the ranks of `mesh`, in f64, with
    its own checks: 20 (fast) or 40 Adam steps on the ring's stochastic
    logpdf (fresh probes each step) recovering ℓ and the noise, the ring
    posterior at 64 points (positive variances), and the ring posterior
    against the dense one at N = 512.  Returns its numbers."""
    from stheno_tpu_torch.parallel import ring_posterior_mean_var, shard_rows

    dev = resolve_device(device)
    mesh = _mesh_for(mesh, dev)
    f64 = torch.float64
    n = 1024 if fast else 4096
    x, y = matrix_free_data(n, f64, dev)
    x_sh, y_sh = shard_rows(mesh, x), shard_rows(mesh, y)
    logp = torch.log(torch.tensor([1.0, 1.0, 0.3], dtype=f64, device=dev)).requires_grad_(True)
    opt = torch.optim.Adam([logp], lr=0.08)
    steps = 20 if fast else 40
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        gen = torch.Generator(device=dev).manual_seed(i)
        val = matrix_free_nlml(mesh, x_sh, y_sh, logp, gen, num_probes=8, lanczos_iters=15,
                               tol=1e-8, maxiter=400)
        val.backward()
        opt.step()
    v, l, s = (t.item() for t in torch.exp(logp.detach()))
    out = dict(nlml=val.item(), v=v, l=l, noise=s, steps=steps)
    _check(0.4 < l < 1.2 and 0.05 < s < 0.2, f"hyperparameters off: {out}")
    k_fit = v * with_lengthscale(SEKernel(), l)
    xs = torch.linspace(-6.0, 6.0, 64, dtype=f64, device=dev)
    m, var, its = ring_posterior_mean_var(mesh, k_fit, x_sh, y_sh, s, xs, tol=1e-10, maxiter=600)
    out["cg_iters"] = its
    _check(bool((var > 0).all()), "negative posterior variance")
    xr, yr = x[:512], y[:512]
    mr, vr, _ = ring_posterior_mean_var(mesh, k_fit, shard_rows(mesh, xr), shard_rows(mesh, yr), s,
                                        xs, tol=1e-12, maxiter=800)
    with torch.no_grad():
        post = posterior(GP(k_fit, gpc=GPC())(xr, s), yr)
        out["dm"] = (mr - post.mean(xs)).abs().max().item()
        out["dv"] = (vr - post.var(xs)).abs().max().item()
    _check(out["dm"] < 1e-6 and out["dv"] < 1e-6, f"ring vs dense posterior {out['dm']}, {out['dv']}")
    return out


def svgp_dp_data(n_total, dtype=torch.float64, device="cuda", seed=0):
    """`examples/svgp_data_parallel.py`'s data: x uniform on [−6, 6],
    f(x) = sin(2x)·e^{−x²/8}, labels ~ Bernoulli(Φ(3 f(x))) (numpy)."""
    from math import erf, sqrt

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-6, 6, n_total)
    f = np.sin(2 * x) * np.exp(-(x**2) / 8)
    p = 0.5 * (1.0 + np.vectorize(erf)(3 * f / sqrt(2.0)))
    y = (rng.uniform(size=n_total) < p).astype(np.float64)
    return tuple(torch.as_tensor(a, dtype=dtype, device=dev) for a in (x, y)), rng


def svgp_data_parallel_example(n_total=100_000, steps=60, batch=4096, m_ind=48, mesh=None,
                               device="cuda"):
    """`examples/svgp_data_parallel.py` on the ranks of a 'data' mesh, in
    f64, with its own checks: a Bernoulli SVGP trained by Adam on
    minibatches sharded over the ranks (`svgp_elbo_dp`; every rank draws
    the same batch from the same generator and takes its rows), the bound
    improving and the predictive probability within 0.15 RMSE of the
    truth.  Returns its numbers."""
    from stheno_tpu_torch.inference import SVGP, BernoulliLikelihood, svgp_init, svgp_posterior
    from stheno_tpu_torch.parallel import svgp_elbo_dp

    dev = resolve_device(device)
    mesh = _mesh_for(mesh, dev, "data")
    f64 = torch.float64
    (x_all, y_all), rng = svgp_dp_data(n_total, f64, dev)
    f = GP(1.5 * with_lengthscale(SEKernel(), 1.0), gpc=GPC())
    z = torch.linspace(-6.0, 6.0, m_ind, dtype=f64, device=dev)
    lik = BernoulliLikelihood()
    fz = f(z, 1e-9)
    q0 = svgp_init(fz)
    params = [q0.q_mu.clone().requires_grad_(True), q0.q_sqrt.clone().requires_grad_(True)]
    opt = torch.optim.Adam(params, lr=0.15)
    scale = n_total / batch
    vals = []
    for _ in range(steps):
        idx = torch.as_tensor(rng.integers(0, n_total, batch), device=dev)
        opt.zero_grad(set_to_none=True)
        loss = -svgp_elbo_dp(mesh, SVGP(fz, *params), f(x_all[idx], 1e-9), y_all[idx],
                             scale=scale, likelihood=lik)
        loss.backward()
        opt.step()
        vals.append(loss.item())
    with torch.no_grad():
        post = svgp_posterior(SVGP(fz, *params))
        xg = torch.linspace(-5.0, 5.0, 200, dtype=f64, device=dev)
        p_hat, _ = lik.predictive_mean_var(*post.mean_and_var(xg))
        fg = torch.sin(2 * xg) * torch.exp(-(xg**2) / 8)
        p_g = 0.5 * (1.0 + torch.erf(3 * fg / math.sqrt(2.0)))
        rmse = torch.sqrt(torch.mean((p_hat - p_g) ** 2)).item()
    out = dict(first=vals[0], last=vals[-1], rmse=rmse, steps=steps)
    _check(vals[-1] < vals[0], "ELBO did not improve")
    _check(rmse < 0.15, f"predictive rmse {rmse:.3f}")
    return out

"""SVGP: uncollapsed stochastic variational inference with inducing points
(Hensman et al. 2013; counterpart of `stheno_tpu/inference/svgp.py`).

Where `elbo(VFE(u), fx, y)` marginalises q(u) in closed form and needs the
whole data set at each evaluation (O(N M²)), SVGP keeps an explicit
variational distribution and pays O(|B| M²) a minibatch, so the
hyperparameters and the variational parameters train together on unbiased
minibatch estimates.  At the optimum over q the bound equals the collapsed
Titsias ELBO.

- Whitened parametrisation: q(u) = N(m_z + Luu·q_mu, Luu·S·Luuᵀ) with
  S = q_sqrt·q_sqrtᵀ, so the KL is against N(0, I).
- Interdomain inducing points: `fz` may tag any process of a GPPP, latent
  ones included, as for VFE.

    svgp_init(fz)                      → SVGP (q_mu = 0, q_sqrt = I)
    svgp_elbo(svgp, fx, y, scale=1.0)  → the bound; `scale` = N/|B| for a
                                          minibatch
    svgp_posterior(svgp)               → the q-posterior process
    svgp_optimal_gaussian(svgp, fx, y) → the optimal q for Gaussian noise
"""

from __future__ import annotations

import math

import torch

from stheno_tpu_torch.finite_gp import VFE, DiagNoise, FiniteGP, _cross_cov_any, _like, posterior_vfe
from stheno_tpu_torch.inputs import input_device, input_dtype
from stheno_tpu_torch.ops import chol as _chol
from stheno_tpu_torch.tree import frozen_dataclass


@frozen_dataclass(eq=False)
class SVGP:
    """The inducing FiniteGP and the whitened variational parameters."""

    fz: FiniteGP
    q_mu: torch.Tensor  # (M,)
    q_sqrt: torch.Tensor  # (M, M); its lower triangle is used


def svgp_init(fz: FiniteGP) -> SVGP:
    """q(ε) = N(0, I), so the initial approximate posterior is the prior.
    The parameters take the inducing inputs' dtype (at least float32) and
    device."""
    m = len(fz)
    dt, dev = input_dtype(fz.x), input_device(fz.x)
    return SVGP(fz, torch.zeros((m,), dtype=dt, device=dev), torch.eye(m, dtype=dt, device=dev))


def _svgp_factors(svgp: SVGP):
    Luu = _chol.cholesky_psd(svgp.fz.cov())  # Kuu with fz's noise
    return Luu, torch.tril(svgp.q_sqrt)


def _q_marginals(svgp: SVGP, Luu, q_sqrt, f, x):
    """Marginal means and variances of q(f(x)) for a (process, inputs) pair
    of the programme."""
    Kuf = _cross_cov_any(svgp.fz.f, svgp.fz.x, f, x)
    V = _chol.solve_lower(Luu, Kuf)  # (M, N)
    mu = f.mean(x) + V.T @ svgp.q_mu
    W = q_sqrt.T @ V
    var = f.var(x) - torch.sum(V * V, dim=0) + torch.sum(W * W, dim=0)
    return mu, var


def svgp_elbo(svgp: SVGP, fx: FiniteGP, y, scale=1.0, likelihood=None):
    """The minibatch ELBO: scale·Σᵢ E_q[log p(yᵢ | fᵢ)] − KL(q(ε) ‖ N(0, I)).

    `fx` and `y` are the minibatch, and `scale` = N/|B| makes the data term
    an unbiased estimate of the full sum.  With `likelihood=None` the
    observation model is Gaussian with `fx`'s diagonal noise; any
    `Likelihood` (Bernoulli, Poisson, Student-t) makes it the non-conjugate
    SVGP, where `fx` should carry only jitter."""
    Luu, q_sqrt = _svgp_factors(svgp)
    mu, var = _q_marginals(svgp, Luu, q_sqrt, fx.f, fx.x)
    y = _like(y, mu)
    if likelihood is not None:
        ell = likelihood.variational_expectation(mu, var, y)
    else:
        if not isinstance(fx.noise, DiagNoise):
            raise TypeError(
                "svgp_elbo requires diagonal observation noise (or pass an explicit likelihood=)")
        s = _like(fx.noise.diag(len(fx)), mu)
        ell = torch.sum(-0.5 * (torch.log(2.0 * math.pi * s) + (y - mu) ** 2 / s + var / s))
    m = svgp.q_mu.shape[0]
    kl = 0.5 * (
        torch.dot(svgp.q_mu, svgp.q_mu)
        + torch.sum(q_sqrt * q_sqrt)
        - m
        - 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(q_sqrt))))
    )
    return scale * ell - kl


@frozen_dataclass(eq=False)
class SVGPPosteriorGP:
    """The q-posterior process, at any tagged inputs of the programme:

        mean(x)    = m(x) + V(x)ᵀ q_mu,                  V(x) = Luu⁻¹ K(z, x)
        cov(x, x') = K(x, x') − V(x)ᵀ V(x') + W(x)ᵀ W(x'),  W = q_sqrtᵀ V
    """

    prior: object
    z: object
    Luu: torch.Tensor
    q_mu: torch.Tensor
    q_sqrt: torch.Tensor

    def _v(self, x):
        return _chol.solve_lower(self.Luu, self.prior.cov2(self.z, x))

    def mean(self, x):
        return self.prior.mean(x) + self._v(x).T @ self.q_mu

    def cov(self, x):
        V = self._v(x)
        W = self.q_sqrt.T @ V
        return self.prior.cov(x) - V.T @ V + W.T @ W

    def cov2(self, x, x2):
        V, V2 = self._v(x), self._v(x2)
        W, W2 = self.q_sqrt.T @ V, self.q_sqrt.T @ V2
        return self.prior.cov2(x, x2) - V.T @ V2 + W.T @ W2

    def var(self, x):
        V = self._v(x)
        W = self.q_sqrt.T @ V
        return self.prior.var(x) - torch.sum(V * V, dim=0) + torch.sum(W * W, dim=0)

    def var2(self, x, x2):
        V, V2 = self._v(x), self._v(x2)
        W, W2 = self.q_sqrt.T @ V, self.q_sqrt.T @ V2
        return self.prior.var2(x, x2) - torch.sum(V * V2, dim=0) + torch.sum(W * W2, dim=0)

    def mean_and_cov(self, x):
        return self.mean(x), self.cov(x)

    def mean_and_var(self, x):
        return self.mean(x), self.var(x)

    def __call__(self, x, noise=None):
        return FiniteGP(self, x, noise)


def svgp_posterior(svgp: SVGP) -> SVGPPosteriorGP:
    Luu, q_sqrt = _svgp_factors(svgp)
    return SVGPPosteriorGP(svgp.fz.f, svgp.fz.x, Luu, svgp.q_mu, q_sqrt)


def svgp_optimal_gaussian(svgp: SVGP, fx: FiniteGP, y) -> SVGP:
    """The closed-form optimal q for Gaussian noise over the full batch, at
    which `svgp_elbo` equals the collapsed `elbo`:

        S* = B⁻¹,  m* = B⁻¹ A b,  B = I + A Aᵀ,  A = Luu⁻¹ Kuf / √s,

    which are the VFE posterior's c and LB (`posterior_vfe`)."""
    post = posterior_vfe(VFE(svgp.fz), fx, y)  # diagonal noise only (TypeError)
    eye = torch.eye(post.LB.shape[-1], dtype=post.LB.dtype, device=post.LB.device)
    # S* = LB⁻ᵀ LB⁻¹, so LB⁻ᵀ is a square root (upper); q_sqrt is S*'s lower factor
    q_sqrt = _chol.solve_lower(post.LB, eye, trans=True)
    return SVGP(svgp.fz, post.c, _chol.cholesky_psd(q_sqrt @ q_sqrt.T))


__all__ = ["SVGP", "svgp_init", "svgp_elbo", "svgp_posterior", "svgp_optimal_gaussian",
           "SVGPPosteriorGP"]

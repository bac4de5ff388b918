"""Non-Gaussian observation likelihoods (counterpart of
`stheno_tpu/inference/likelihoods.py`): Gaussian, Bernoulli, Poisson and
Student-t, for the SVGP bound (`svgp_elbo(..., likelihood=...)`) and the
Laplace approximation (`laplace`).

An expectation without a closed form is a fixed-order Gauss–Hermite
quadrature: an (N, Q) broadcast and a sum.  The nodes come from numpy
(`np.polynomial.hermite.hermgauss`), as in the reference.  Closed forms are
used where they exist (Gaussian; Poisson with the exp link; the probit
predictive).

A numeric parameter (a noise variance, a Student-t scale) may be a tensor,
which autograd reaches, or a Python number; either takes the dtype and
device of the values it meets.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from stheno_tpu_torch.finite_gp import _like
from stheno_tpu_torch.tree import frozen_dataclass, static_field


def _gh_nodes(n, dtype, device):
    """Gauss–Hermite nodes and weights for E_{N(mu, var)}[g(f)]:
    E ≈ Σᵢ (wᵢ/√π) g(mu + √(2 var)·tᵢ)."""
    t, w = np.polynomial.hermite.hermgauss(n)
    return (torch.as_tensor(t, dtype=dtype, device=device),
            torch.as_tensor(w / np.sqrt(np.pi), dtype=dtype, device=device))


class Likelihood:
    """A factorised observation model p(y | f) = Πᵢ p(yᵢ | fᵢ).

    A concrete likelihood gives the elementwise `log_prob(f, y)` and the
    conditional moments `conditional_mean(f)` and `conditional_variance(f)`;
    the quadrature defaults below turn them into the variational expectation
    E_{N(mu, var)}[log p(y | f)] (the SVGP data term) and the predictive
    moments of y.  Closed forms override the quadrature where they exist.
    """

    # quadrature order; the subclasses declare it as a static field
    n_gh = 20

    def log_prob(self, f, y):  # pragma: no cover - interface
        raise NotImplementedError

    def conditional_mean(self, f):  # pragma: no cover - interface
        raise NotImplementedError

    def conditional_variance(self, f):  # pragma: no cover - interface
        raise NotImplementedError

    def _quad(self, g, mu, var):
        """E_{N(mu, var)}[g(f)] elementwise by Gauss–Hermite quadrature."""
        mu = torch.as_tensor(mu)
        t, w = _gh_nodes(self.n_gh, mu.dtype, mu.device)
        # marginal variances computed by subtraction can go slightly
        # negative from f32 cancellation: clamp, or one entry makes the
        # whole sum NaN
        var = _like(var, mu)
        f = mu[..., None] + torch.sqrt(2.0 * torch.clamp(var, min=0.0))[..., None] * t
        return torch.sum(g(f) * w, dim=-1)

    def variational_expectation(self, mu, var, y):
        """Σᵢ E_{N(muᵢ, varᵢ)}[log p(yᵢ | fᵢ)]."""
        y = _like(y, torch.as_tensor(mu))
        return torch.sum(self._quad(lambda f: self.log_prob(f, y[..., None]), mu, var))

    def predictive_mean_var(self, mu, var):
        """Moments of y under f ~ N(mu, var): E[y] = E[m(f)] and
        Var[y] = E[v(f)] + Var[m(f)]."""
        ey = self._quad(self.conditional_mean, mu, var)
        ey2 = self._quad(
            lambda f: self.conditional_variance(f) + self.conditional_mean(f) ** 2, mu, var)
        return ey, ey2 - ey**2


@frozen_dataclass
class GaussianLikelihood(Likelihood):
    """y | f ~ N(f, variance), in closed form throughout."""

    variance: object = 1.0
    n_gh: int = static_field(default=20)

    def log_prob(self, f, y):
        s = _like(self.variance, f)
        return -0.5 * (torch.log(2.0 * math.pi * s) + (_like(y, f) - f) ** 2 / s)

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        return torch.broadcast_to(_like(self.variance, f), f.shape)

    def variational_expectation(self, mu, var, y):
        mu = torch.as_tensor(mu)
        s = _like(self.variance, mu)
        return torch.sum(
            -0.5 * (torch.log(2.0 * math.pi * s) + ((_like(y, mu) - mu) ** 2 + var) / s))

    def predictive_mean_var(self, mu, var):
        return mu, var + _like(self.variance, torch.as_tensor(mu))


@frozen_dataclass
class BernoulliLikelihood(Likelihood):
    """y ∈ {0, 1} with P(y = 1 | f) = link(f).

    link='probit' (the default): Φ(f), whose predictive probability under
    N(mu, var) is exact, Φ(mu / √(1 + var)).  link='logit': σ(f), with its
    expectations by quadrature."""

    link: str = static_field(default="probit")
    n_gh: int = static_field(default=20)

    def _log_p1(self, f):
        if self.link == "probit":
            return torch.special.log_ndtr(f)
        return F.logsigmoid(f)

    def log_prob(self, f, y):
        # symmetric links: P(y = 0 | f) = P(y = 1 | −f)
        return torch.where(_like(y, f) > 0.5, self._log_p1(f), self._log_p1(-f))

    def conditional_mean(self, f):
        return torch.exp(self._log_p1(f))

    def conditional_variance(self, f):
        p = self.conditional_mean(f)
        return p * (1.0 - p)

    def predictive_mean_var(self, mu, var):
        if self.link == "probit":
            p = torch.special.ndtr(mu / torch.sqrt(1.0 + var))
        else:
            p = self._quad(self.conditional_mean, mu, var)
        return p, p * (1.0 - p)


@frozen_dataclass
class PoissonLikelihood(Likelihood):
    """y ∈ ℕ with rate link(f).  link='exp' (the default) has the closed-form
    variational expectation y·mu − e^{mu + var/2} − log y!; link='softplus'
    takes quadrature."""

    link: str = static_field(default="exp")
    n_gh: int = static_field(default=20)

    def _rate(self, f):
        return torch.exp(f) if self.link == "exp" else F.softplus(f)

    def log_prob(self, f, y):
        y = _like(y, f)
        if self.link == "exp":
            # y·log λ = y·f stays finite where exp(f) overflows
            return y * f - torch.exp(f) - torch.lgamma(y + 1.0)
        lam = self._rate(f)
        return y * torch.log(lam) - lam - torch.lgamma(y + 1.0)

    def conditional_mean(self, f):
        return self._rate(f)

    def conditional_variance(self, f):
        return self._rate(f)

    def variational_expectation(self, mu, var, y):
        if self.link != "exp":
            return super().variational_expectation(mu, var, y)
        y = _like(y, torch.as_tensor(mu))
        return torch.sum(y * mu - torch.exp(mu + 0.5 * var) - torch.lgamma(y + 1.0))

    def predictive_mean_var(self, mu, var):
        if self.link != "exp":
            return super().predictive_mean_var(mu, var)
        ey = torch.exp(mu + 0.5 * var)  # the lognormal mean
        return ey, ey + (torch.exp(var) - 1.0) * ey**2


@frozen_dataclass
class StudentTLikelihood(Likelihood):
    """y | f ~ StudentT(df, loc=f, scale), with its expectations by
    quadrature.  It is not log-concave: Laplace clips its curvature at 0."""

    df: object = 4.0
    scale: object = 1.0
    n_gh: int = static_field(default=20)

    def log_prob(self, f, y):
        v, s = _like(self.df, f), _like(self.scale, f)
        z = (_like(y, f) - f) / s
        return (
            torch.lgamma((v + 1.0) / 2.0)
            - torch.lgamma(v / 2.0)
            - 0.5 * torch.log(v * math.pi)
            - torch.log(s)
            - (v + 1.0) / 2.0 * torch.log1p(z**2 / v)
        )

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        # finite for df > 2
        v, s = _like(self.df, f), _like(self.scale, f)
        return torch.broadcast_to(s**2 * v / (v - 2.0), f.shape)

    def predictive_mean_var(self, mu, var):
        mu = torch.as_tensor(mu)
        v, s = _like(self.df, mu), _like(self.scale, mu)
        return mu, var + s**2 * v / (v - 2.0)


__all__ = [
    "Likelihood",
    "GaussianLikelihood",
    "BernoulliLikelihood",
    "PoissonLikelihood",
    "StudentTLikelihood",
]

"""The Laplace approximation for exact GPs with non-Gaussian likelihoods
(counterpart of `stheno_tpu/inference/laplace.py`; GPML, Rasmussen and
Williams, Algorithms 3.1 and 3.2): Newton iteration to the mode f̂ of
p(f | y), a Gaussian with the mode's curvature, and the Laplace log
evidence for hyperparameter learning.

- A fixed number of damped Newton steps (a Python loop where the reference
  scans).  Each step factors B = I + √W K √W (the blocked path and kernels
  2 and 3 for a large f32 B on the card) and takes two triangular solves.
  In place of a line search it evaluates the objective Ψ at a fixed grid of
  five step sizes as one batch and keeps the best, taken by index so the
  gradient flows through every step; the natural parameter a = K⁻¹(f − m)
  is carried beside f, so Ψ needs no extra solve.  Hyperparameter gradients
  flow through the unrolled steps.
- `LaplacePosteriorGP` answers mean/cov/cov2/var/var2 at any tagged inputs,
  so cross-process prediction through a GPPP works as for the other
  posteriors.
- For a likelihood that is not log-concave (Student-t) the curvature W is
  clipped at 0.
"""

from __future__ import annotations

import torch
from torch.func import grad

from stheno_tpu_torch.finite_gp import FiniteGP, _cross_cov_any, _like
from stheno_tpu_torch.ops import chol as _chol
from stheno_tpu_torch.tree import frozen_dataclass


def _d_log_prob(likelihood, f, y):
    """Elementwise ∂/∂f log p(y | f) and the clipped curvature
    W = −∂²/∂f² log p(y | f).  `log_prob` is elementwise, so the gradient of
    its sum is the elementwise derivative.  `torch.func.grad` composes with
    the outer autograd, so both stay differentiable in f and in the
    likelihood's parameters."""

    def d1(fv):
        return grad(lambda u: likelihood.log_prob(u, y).sum())(fv)

    dll = d1(f)
    w = -grad(lambda u: d1(u).sum())(f)
    return dll, torch.clamp(w, min=0.0)


@frozen_dataclass(eq=False)
class LaplacePosteriorGP:
    """The Gaussian approximation q(f·) of the Laplace fit:

        mean(x)    = m(x) + K(x, X) α,          α = K⁻¹(f̂ − m)
        cov(x, x') = K(x, x') − V(x)ᵀ V(x'),    V(x) = L⁻¹ √W K(X, x)

    with L = chol(I + √W K √W) (GPML eqs. 3.27 and 3.29)."""

    prior: object  # the observed process (any node of a GPPP)
    x: object  # the training inputs (tagged or not)
    alpha: torch.Tensor  # (N,)
    w_sqrt: torch.Tensor  # (N,)
    L: torch.Tensor  # (N, N) lower

    def _kxs(self, f, x):
        return _cross_cov_any(self.prior, self.x, f, x)

    def _v(self, x):
        return _chol.solve_lower(self.L, self.w_sqrt[:, None] * self._kxs(self.prior, x))

    def mean(self, x):
        return self.prior.mean(x) + self._kxs(self.prior, x).T @ self.alpha

    def cov(self, x):
        V = self._v(x)
        return self.prior.cov(x) - V.T @ V

    def cov2(self, x, x2):
        return self.prior.cov2(x, x2) - self._v(x).T @ self._v(x2)

    def var(self, x):
        V = self._v(x)
        return self.prior.var(x) - torch.sum(V * V, dim=0)

    def var2(self, x, x2):
        return self.prior.var2(x, x2) - torch.sum(self._v(x) * self._v(x2), dim=0)

    def mean_and_cov(self, x):
        return self.mean(x), self.cov(x)

    def mean_and_var(self, x):
        return self.mean(x), self.var(x)

    def __call__(self, x, noise=None):
        return FiniteGP(self, x, noise)


@frozen_dataclass(eq=False)
class LaplaceResult:
    posterior: LaplacePosteriorGP
    log_evidence: torch.Tensor  # the Laplace approximation of log p(y | θ)
    f_hat: torch.Tensor  # the posterior mode of f(X)
    newton_decrement: torch.Tensor  # max |f step| of the last step


def _newton_matrix(K, w_sqrt):
    """B = I + √W K √W."""
    n = K.shape[0]
    return torch.eye(n, dtype=K.dtype, device=K.device) + (w_sqrt[:, None] * K) * w_sqrt[None, :]


def laplace(fx: FiniteGP, y, likelihood, num_iters: int = 30) -> LaplaceResult:
    """Newton mode-finding (GPML Alg. 3.1 with a prior mean): maximise
    Ψ(f) = log p(y | f) − ½ (f − m)ᵀ K⁻¹ (f − m).

    `fx` should carry only jitter-scale noise: the observation model is
    `likelihood`.  Returns the posterior process, the Laplace log evidence
    (eq. 3.32), the mode and the last step's size."""
    K = fx.cov()  # with fx's jitter, which keeps B well conditioned
    m = fx.mean()
    y = _like(y, K)
    # the fixed step-size grid of the damped Newton step
    etas = torch.tensor([1.0, 0.5, 0.25, 0.1, 0.03], dtype=K.dtype, device=K.device)

    f, a = m, torch.zeros_like(m)
    step = None
    for _ in range(num_iters):
        dll, w = _d_log_prob(likelihood, f, y)
        w_sqrt = torch.sqrt(w)
        L = _chol.cholesky_psd(_newton_matrix(K, w_sqrt))
        b = w * (f - m) + dll
        c = _chol.solve_lower(L, w_sqrt * (K @ b))
        a1 = b - w_sqrt * _chol.solve_lower(L, c, trans=True)
        f1 = m + K @ a1
        # candidates f(η) = f + η(f1 − f); a(η) = a + η(a1 − a) stays K⁻¹(f(η) − m)
        fs = f[None, :] + etas[:, None] * (f1 - f)[None, :]
        as_ = a[None, :] + etas[:, None] * (a1 - a)[None, :]
        psis = torch.sum(likelihood.log_prob(fs, y), dim=-1) - 0.5 * torch.sum(as_ * (fs - m), dim=-1)
        i = torch.argmax(psis)
        f_new, a_new = fs[i], as_[i]
        step = torch.max(torch.abs(f_new - f))
        f, a = f_new, a_new

    dll, w = _d_log_prob(likelihood, f, y)
    w_sqrt = torch.sqrt(w)
    L = _chol.cholesky_psd(_newton_matrix(K, w_sqrt))
    # α = K⁻¹(f̂ − m), carried exactly; it equals ∇ log p(y | f̂) at the mode
    log_z = (
        -0.5 * torch.dot(a, f - m)
        + torch.sum(likelihood.log_prob(f, y))
        - torch.sum(torch.log(torch.diagonal(L)))
    )
    return LaplaceResult(LaplacePosteriorGP(fx.f, fx.x, a, w_sqrt, L), log_z, f, step)


__all__ = ["laplace", "LaplaceResult", "LaplacePosteriorGP"]

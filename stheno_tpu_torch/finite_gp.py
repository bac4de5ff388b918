"""FiniteGP and the exact-inference verbs (counterpart of
`stheno_tpu/finite_gp.py:33-279`): observation noise, `FiniteGP`, `logpdf`,
`posterior`/`PosteriorGP`, `marginals` and `rand`.

Observations `y` and a dense noise matrix given on the host (numpy, or a
tensor on another device) are moved to the covariance's device and dtype.

Not ported yet: VFE/`elbo`, `ApproxPosteriorGP`, `SparseFiniteGP` (and so
`rand`'s sparse branch).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stheno_tpu_torch.config import default_jitter
from stheno_tpu_torch.inputs import input_dtype, input_length
from stheno_tpu_torch.ops import chol as _chol
from stheno_tpu_torch.tree import frozen_dataclass


class _AddDiagInPlace(torch.autograd.Function):
    """K.diagonal() += d in place, with K̄ passed through and d̄ = diag(K̄)
    (summed for a scalar d).  Adding d·I instead would allocate and add a
    second N×N matrix (1 GiB at N = 16384 in f32)."""

    @staticmethod
    def forward(ctx, K, d):
        ctx.d_shape = d.shape
        ctx.d_device = d.device
        K.diagonal().add_(d.to(K.device))
        ctx.mark_dirty(K)
        return K

    @staticmethod
    def backward(ctx, K_bar):
        gd = None
        if ctx.needs_input_grad[1]:
            gd = K_bar.diagonal().sum_to_size(ctx.d_shape).to(ctx.d_device)
        return K_bar, gd


@frozen_dataclass
class DiagNoise:
    """Diagonal observation noise; `d` broadcasts against (N,)."""

    d: torch.Tensor

    def add_to(self, K):
        """K + diag(d), written into the diagonal of K (K must be a fresh
        covariance that nothing else holds)."""
        return _AddDiagInPlace.apply(K, torch.as_tensor(self.d).to(dtype=K.dtype))

    def diag(self, n):
        return torch.broadcast_to(self.d, (n,))


@frozen_dataclass
class FullNoise:
    """Dense noise covariance (correlated observation noise)."""

    S: torch.Tensor

    def add_to(self, K):
        return K + _like(self.S, K)

    def diag(self, n):
        return torch.diagonal(self.S)


def as_noise(noise, dtype):
    """None → dtype-scaled jitter; scalar/vector → diagonal; (N, N) → full."""
    if isinstance(noise, (DiagNoise, FullNoise)):
        return noise
    if noise is None:
        return DiagNoise(torch.tensor(default_jitter(dtype), dtype=dtype))
    if not torch.is_tensor(noise):
        noise = torch.as_tensor(noise, dtype=dtype)
    if noise.dim() == 2:
        return FullNoise(noise)
    return DiagNoise(noise)


@frozen_dataclass(eq=False)
class FiniteGP:
    """A process `f` at finite inputs `x` with observation noise: a
    multivariate normal (`f(x, Σ)`)."""

    f: object
    x: object
    noise: object = None

    def __post_init__(self):
        if not isinstance(self.noise, (DiagNoise, FullNoise)):
            object.__setattr__(self, "noise", as_noise(self.noise, input_dtype(self.x)))

    def __len__(self):
        return input_length(self.x)

    def mean(self):
        return self.f.mean(self.x)

    def cov(self):
        return self.noise.add_to(self.f.cov(self.x))

    def var(self):
        v = self.f.var(self.x)
        return v + self.noise.diag(len(self)).to(v.device)

    def mean_and_cov(self):
        return self.mean(), self.cov()

    def mean_and_var(self):
        return self.mean(), self.var()


class Marginals(NamedTuple):
    """Per-point marginals."""

    mean: torch.Tensor
    var: torch.Tensor

    @property
    def std(self):
        return torch.sqrt(self.var)


def mean(fx_or_f, x=None):
    if x is None:
        return fx_or_f.mean()
    return fx_or_f.mean(x)


def cov(a, b=None, x=None, x2=None):
    """`cov(fx)`, `cov(f, x)`, `cov(fx, gx)` or `cov(f, g, x, x2)`."""
    from stheno_tpu_torch.graph import AbstractProcess, cross_cov

    if b is None and x is None:
        return a.cov()
    if isinstance(b, FiniteGP):
        if a.f is b.f:
            return a.f.cov2(a.x, b.x)
        if isinstance(a.f, AbstractProcess) and isinstance(b.f, AbstractProcess):
            return cross_cov(a.f, b.f, a.x, b.x)
        raise TypeError("cov(fx, gx) requires processes from the same programme")
    if x is None:
        return a.cov(b)
    return cross_cov(a, b, x, x if x2 is None else x2)


def var(fx_or_f, x=None):
    if x is None:
        return fx_or_f.var()
    return fx_or_f.var(x)


def mean_and_cov(fx):
    return fx.mean_and_cov()


def mean_and_var(fx):
    return fx.mean_and_var()


def marginals(fx: FiniteGP) -> Marginals:
    """Per-point marginal mean and variance including observation noise."""
    m, v = fx.mean_and_var()
    return Marginals(m, v)


def _like(t, ref):
    """`t` (a tensor, numpy array or number) on `ref`'s device and dtype."""
    return torch.as_tensor(t).to(device=ref.device, dtype=ref.dtype)


def logpdf(fx, y):
    """log N(y; m, K + Σ).  `y` may be (N,) or (N, S)."""
    K = fx.cov()
    return _chol.mvn_logpdf_psd(_like(y, K), fx.mean(), K)


def rand(generator, fx, num_samples=None):
    """Sample y ~ N(mean, K + Σ): (N,), or (N, S) with `num_samples` = S,
    the reference's column convention.  `generator` is a `torch.Generator`
    on the covariance's device (or None for PyTorch's default generator);
    it takes the place of the reference's key.  The factor takes the same
    route as `logpdf`'s, so a large f32 covariance on the card is factored
    by the blocked path and its kernels."""
    L = _chol.cholesky_psd(fx.cov())
    S = 1 if num_samples is None else num_samples
    y = _chol.mvn_sample_chol(generator, fx.mean(), L, (S,)).mT
    return y[:, 0] if num_samples is None else y


@frozen_dataclass(eq=False)
class PosteriorGP:
    """Posterior process after exact conditioning on `y` at `x_obs`.  It
    answers the same statistics queries as a prior process, at any tagged
    inputs of the prior programme ("observe f3, read off f1")."""

    prior: object
    x_obs: object
    L: torch.Tensor  # chol(K_obs + Σ)
    alpha: torch.Tensor  # (K_obs + Σ)⁻¹ (y − m_obs)

    def _a(self, x):
        """L⁻¹ K(x_obs, x), the shared O(N_obs² · N) solve."""
        return _chol.solve_lower(self.L, self.prior.cov2(self.x_obs, x))

    def mean(self, x):
        return self.prior.mean(x) + self.prior.cov2(x, self.x_obs) @ self.alpha

    def cov(self, x):
        A = self._a(x)
        return self.prior.cov(x) - A.T @ A

    def cov2(self, x, x2):
        return self.prior.cov2(x, x2) - self._a(x).T @ self._a(x2)

    def var(self, x):
        A = self._a(x)
        return self.prior.var(x) - torch.sum(A * A, dim=0)

    def var2(self, x, x2):
        return self.prior.var2(x, x2) - torch.sum(self._a(x) * self._a(x2), dim=0)

    def mean_and_cov(self, x):
        return self.mean(x), self.cov(x)

    def mean_and_var(self, x):
        return self.mean(x), self.var(x)

    def __call__(self, x, noise=None):
        return FiniteGP(self, x, noise)


def posterior(fx, y):
    """Condition `f(x, Σ)` on `y`: one factorisation, reused by every
    prediction."""
    L = _chol.cholesky_psd(fx.cov())
    alpha = _chol.chol_solve(L, _like(y, L) - fx.mean())
    return PosteriorGP(fx.f, fx.x, L, alpha)

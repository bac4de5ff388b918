"""FiniteGP and the inference verbs (counterpart of
`stheno_tpu/finite_gp.py`): observation noise, `FiniteGP`, `logpdf`,
`posterior`/`PosteriorGP`, `marginals` and `rand`; and the pseudo-point
family: `VFE` with the collapsed Titsias bound `elbo`, the approximate
posterior `posterior_vfe`/`ApproxPosteriorGP`, and `SparseFiniteGP`, whose
`logpdf` is the ELBO and whose `posterior` is the VFE posterior.

The VFE path is O(N M²) and never forms an N×N matrix: with
Luu = chol(Kuu), A = Luu⁻¹ Kuf / √s and B = I + A Aᵀ = LB LBᵀ, every
quantity is a GEMM, a triangular solve or a factor of an M×M matrix.  The
pseudo-points may tag any process of a GPPP, latent ones included
(interdomain inducing points).

Observations `y` and a dense noise matrix given on the host (numpy, or a
tensor on another device) are moved to the covariance's device and dtype.

Spans (`utils/logging.py`): each public verb is one (`logpdf`, `elbo`,
`posterior`, `rand`, and the posteriors' `posterior.mean`, `posterior.var`,
`posterior.cov`, `cov2` and `var2` under the same names), and each
covariance block asked of the process graph is a `cov` span, credited with
the entries it assembles (`elems`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from stheno_tpu_torch.config import default_jitter
from stheno_tpu_torch.func_transforms import under_transform
from stheno_tpu_torch.inputs import input_dtype, input_length
from stheno_tpu_torch.ops import chol as _chol
from stheno_tpu_torch.tree import frozen_dataclass
from stheno_tpu_torch.utils import logging as _trace


class _AddDiagInPlace(torch.autograd.Function):
    """K.diagonal(offset) += d in place, with K̄ passed through and
    d̄ = K̄.diagonal(offset) (summed for a scalar d).  Adding d·I instead
    would allocate and add a second N×N matrix (1 GiB at N = 16384 in f32).
    A row slab of a matrix, rows [offset, offset + n) of it, takes its band
    of the global diagonal at `offset`."""

    @staticmethod
    def forward(K, d, offset):
        K.diagonal(offset=offset).add_(d.to(K.device))
        return K

    @staticmethod
    def setup_context(ctx, inputs, output):
        K, d, offset = inputs
        ctx.d_shape = d.shape
        ctx.d_device = d.device
        ctx.offset = offset
        ctx.mark_dirty(K)

    @staticmethod
    def backward(ctx, K_bar):
        gd = None
        if ctx.needs_input_grad[1]:
            gd = K_bar.diagonal(offset=ctx.offset).sum_to_size(ctx.d_shape).to(ctx.d_device)
        return K_bar, gd, None


def _add_diag(K, d, offset=0):
    """K + diag(d) at diagonal `offset` (d a tensor or a number): in place on
    K, a fresh matrix that nothing else holds, outside `torch.func`'s
    transforms; under them (a vmapped batch of covariances, one per chain)
    out of place, which `torch.func` differentiates and batches itself."""
    d = torch.as_tensor(d, dtype=K.dtype)
    if under_transform():
        return K.diagonal_scatter(K.diagonal(offset=offset) + d.to(K.device), offset=offset)
    return _AddDiagInPlace.apply(K, d, offset)


@frozen_dataclass
class DiagNoise:
    """Diagonal observation noise; `d` broadcasts against (N,)."""

    d: torch.Tensor

    def add_to(self, K):
        """K + diag(d), written into the diagonal of K (K must be a fresh
        covariance that nothing else holds)."""
        return _add_diag(K, torch.as_tensor(self.d).to(dtype=K.dtype))

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
        return self.noise.add_to(_block(self.f, "cov", self.x))

    def var(self):
        v = _block(self.f, "var", self.x)
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
    from stheno_tpu_torch.graph import cross_cov

    if b is None and x is None:
        return a.cov()
    if isinstance(b, FiniteGP):
        return _cross_cov_any(a.f, a.x, b.f, b.x)
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


def _graph_block(fn, *args):
    """`fn(*args)`, a covariance block (or its diagonal) of the process
    graph, under a `cov` span credited with its entries."""
    with _trace.span("cov"):
        K = fn(*args)
        if _trace.active:
            _trace.credit("elems", K.numel())
    return K


def _block(f, statistic, *xs):
    """`f.<statistic>(*xs)`: a `_graph_block`, except for a posterior
    process, whose statistics are verbs with spans of their own."""
    if isinstance(f, (PosteriorGP, ApproxPosteriorGP)):
        return getattr(f, statistic)(*xs)
    return _graph_block(getattr(f, statistic), *xs)


def _like(t, ref):
    """`t` (a tensor, numpy array or number) on `ref`'s device and dtype (a
    number is made in that dtype, not rounded through float32 first)."""
    if torch.is_tensor(t):
        return t.to(device=ref.device, dtype=ref.dtype)
    return torch.as_tensor(t, dtype=ref.dtype, device=ref.device)


def logpdf(fx, y):
    """log N(y; m, K + Σ).  `y` may be (N,) or (N, S).  A `SparseFiniteGP`
    gives its ELBO (per column of a 2-D `y`)."""
    if isinstance(fx, SparseFiniteGP):
        return _sparse_logpdf(fx, y)
    with _trace.span("logpdf"):
        K = fx.cov()
        return _chol.mvn_logpdf_psd(_like(y, K), fx.mean(), K)


def rand(generator, fx, num_samples=None):
    """Sample y ~ N(mean, K + Σ): (N,), or (N, S) with `num_samples` = S,
    the reference's column convention.  `generator` is a `torch.Generator`
    on the covariance's device or on the CPU (which draws the same numbers
    whatever the covariance's device), or None for PyTorch's default one;
    it takes the place of the reference's key.  The factor takes the same
    route as `logpdf`'s, so a large f32 covariance on the card is factored
    by the blocked path and its kernels.  A `SparseFiniteGP` samples its
    observation FiniteGP."""
    if isinstance(fx, SparseFiniteGP):
        fx = fx.fobs
    with _trace.span("rand"):
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
        return _chol.solve_lower(self.L, _block(self.prior, "cov2", self.x_obs, x))

    def mean(self, x):
        with _trace.span("posterior.mean"):
            return self.prior.mean(x) + _block(self.prior, "cov2", x, self.x_obs) @ self.alpha

    def cov(self, x):
        with _trace.span("posterior.cov"):
            A = self._a(x)
            return _block(self.prior, "cov", x) - A.T @ A

    def cov2(self, x, x2):
        with _trace.span("posterior.cov"):
            return _block(self.prior, "cov2", x, x2) - self._a(x).T @ self._a(x2)

    def var(self, x):
        with _trace.span("posterior.var"):
            A = self._a(x)
            return _block(self.prior, "var", x) - torch.sum(A * A, dim=0)

    def var2(self, x, x2):
        with _trace.span("posterior.var"):
            return _block(self.prior, "var2", x, x2) - torch.sum(self._a(x) * self._a(x2), dim=0)

    def mean_and_cov(self, x):
        return self.mean(x), self.cov(x)

    def mean_and_var(self, x):
        return self.mean(x), self.var(x)

    def __call__(self, x, noise=None):
        return FiniteGP(self, x, noise)


def posterior(fx, y, y2=None):
    """Condition `f(x, Σ)` on `y`: one factorisation, reused by every
    prediction.  A `SparseFiniteGP` gives the VFE approximate posterior, and
    the reference's `posterior(VFE(u), fx, y)` form is taken too."""
    if isinstance(fx, VFE):
        return posterior_vfe(fx, y, y2)
    if isinstance(fx, SparseFiniteGP):
        return posterior_vfe(VFE(fx.finducing), fx.fobs, y)
    with _trace.span("posterior"):
        L = _chol.cholesky_psd(fx.cov())
        alpha = _chol.chol_solve(L, _like(y, L) - fx.mean())
        return PosteriorGP(fx.f, fx.x, L, alpha)


# ---------------------------------------------------------------------------
# VFE: the Titsias collapsed bound and its approximate posterior
# ---------------------------------------------------------------------------


@frozen_dataclass(eq=False)
class VFE:
    """The Titsias pseudo-point approximation, given by the inducing-point
    FiniteGP `fz` (which may tag any process of a GPPP, latent ones
    included)."""

    fz: FiniteGP


def _cross_cov_any(f, x_f, g, x_g):
    """Covariance between two (process, inputs) pairs on graph nodes or on
    one GPPP with tagged inputs: `cov(fx, gx)`, and pseudo-points against
    observations."""
    from stheno_tpu_torch.graph import AbstractProcess, cross_cov

    if f is g:
        return _block(f, "cov2", x_f, x_g)
    if isinstance(f, AbstractProcess) and isinstance(g, AbstractProcess):
        return _graph_block(cross_cov, f, g, x_f, x_g)
    raise TypeError("the two processes must come from the same programme (same GPPP or same GPC)")


def _vfe_factors(approx: VFE, fx: FiniteGP):
    """(Luu, A, LB, √s): Luu = chol(Kuu + fz's noise), A = Luu⁻¹ Kuf / √s,
    B = I + A Aᵀ = LB LBᵀ."""
    fz, u = approx.fz, approx.fz.f
    if not isinstance(fx.noise, DiagNoise):
        raise TypeError("elbo/VFE requires diagonal observation noise")
    Luu = _chol.cholesky_psd(fz.cov())
    Kuf = _cross_cov_any(u, fz.x, fx.f, fx.x)
    sqrt_s = torch.sqrt(_like(fx.noise.diag(len(fx)), Kuf))
    A = _chol.solve_lower(Luu, Kuf) / sqrt_s[None, :]
    m = A.shape[0]
    B = torch.eye(m, dtype=A.dtype, device=A.device) + A @ A.T
    LB = _chol.cholesky_psd(B)
    return Luu, A, LB, sqrt_s


def elbo(approx: VFE, fx: FiniteGP, y):
    """The Titsias collapsed ELBO, a lower bound on `logpdf(fx, y)`:

        log N(y; m, Qff + Σ) − ½ Σᵢ (Kffᵢᵢ − Qffᵢᵢ)/sᵢ,

    in O(N M²) through the Woodbury and determinant identities."""
    with _trace.span("elbo"):
        Luu, A, LB, sqrt_s = _vfe_factors(approx, fx)
        n = len(fx)
        b = (_like(y, A) - fx.mean()) / sqrt_s
        c = _chol.solve_lower(LB, A @ b)
        log_marginal = -0.5 * (
            n * math.log(2.0 * math.pi)
            + 2.0 * torch.sum(torch.log(sqrt_s))
            + _chol.chol_logdet(LB)
            + b @ b
            - c @ c
        )
        # −½ Σᵢ (kffᵢᵢ − qffᵢᵢ)/sᵢ, with qffᵢᵢ/sᵢ = Σₘ A²[m, i]
        kff_diag = _block(fx.f, "var", fx.x)
        trace_term = -0.5 * (torch.sum(kff_diag / sqrt_s**2) - torch.sum(A * A))
        return log_marginal + trace_term


def elbo_fx(fx: FiniteGP, y, u: FiniteGP):
    """`elbo(fx, y, u)`, the same as `elbo(VFE(u), fx, y)`."""
    return elbo(VFE(u), fx, y)


@frozen_dataclass(eq=False)
class ApproxPosteriorGP:
    """The VFE approximate posterior process (q(u) marginalised):

        mean(x*)     = m(x*) + V*ᵀ c,                V* = Luu⁻¹ K(z, x*)
        cov(x*, x*') = K** − V*ᵀ V*' + W*ᵀ W*',      W* = LB⁻¹ V*

    with c = LB⁻ᵀ LB⁻¹ A b (`posterior_vfe`)."""

    prior: object
    z: object  # the inducing inputs (tagged or not)
    Luu: torch.Tensor
    LB: torch.Tensor
    c: torch.Tensor

    def _v(self, x):
        return _chol.solve_lower(self.Luu, _block(self.prior, "cov2", self.z, x))

    def mean(self, x):
        with _trace.span("posterior.mean"):
            return self.prior.mean(x) + self._v(x).T @ self.c

    def cov(self, x):
        with _trace.span("posterior.cov"):
            V = self._v(x)
            W = _chol.solve_lower(self.LB, V)
            return _block(self.prior, "cov", x) - V.T @ V + W.T @ W

    def cov2(self, x, x2):
        with _trace.span("posterior.cov"):
            V, V2 = self._v(x), self._v(x2)
            W, W2 = _chol.solve_lower(self.LB, V), _chol.solve_lower(self.LB, V2)
            return _block(self.prior, "cov2", x, x2) - V.T @ V2 + W.T @ W2

    def var(self, x):
        with _trace.span("posterior.var"):
            V = self._v(x)
            W = _chol.solve_lower(self.LB, V)
            return _block(self.prior, "var", x) - torch.sum(V * V, dim=0) + torch.sum(W * W, dim=0)

    def var2(self, x, x2):
        with _trace.span("posterior.var"):
            V, V2 = self._v(x), self._v(x2)
            W, W2 = _chol.solve_lower(self.LB, V), _chol.solve_lower(self.LB, V2)
            return (_block(self.prior, "var2", x, x2) - torch.sum(V * V2, dim=0)
                    + torch.sum(W * W2, dim=0))

    def mean_and_cov(self, x):
        return self.mean(x), self.cov(x)

    def mean_and_var(self, x):
        return self.mean(x), self.var(x)

    def __call__(self, x, noise=None):
        return FiniteGP(self, x, noise)


def posterior_vfe(approx: VFE, fx: FiniteGP, y):
    """The approximate posterior under the Titsias approximation: with
    b = (y − m)/√s, it stores c = LB⁻ᵀ LB⁻¹ (A b), so mean(x*) = m* + V*ᵀ c."""
    with _trace.span("posterior"):
        Luu, A, LB, sqrt_s = _vfe_factors(approx, fx)
        b = (_like(y, A) - fx.mean()) / sqrt_s
        c = _chol.solve_lower(LB, A @ b)
        c = _chol.solve_lower(LB, c, trans=True)
        return ApproxPosteriorGP(approx.fz.f, approx.fz.x, Luu, LB, c)


@frozen_dataclass(eq=False)
class SparseFiniteGP:
    """An observation FiniteGP paired with an inducing-point FiniteGP.

    `logpdf` of it is the `elbo`, `posterior` of it the VFE posterior, and
    its `cov` raises rather than densify."""

    fobs: FiniteGP
    finducing: FiniteGP

    def __len__(self):
        return len(self.fobs)

    def mean(self):
        return self.fobs.mean()

    def cov(self):
        raise RuntimeError(
            "The covariance matrix of a sparse GP can often be dense and can "
            "cause the computer to run out of memory. If you are sure you "
            "have enough memory, use `cov(f.fobs)`."
        )

    def mean_and_var(self):
        return self.fobs.mean_and_var()

    def var(self):
        return self.fobs.var()


def _sparse_logpdf(fxu: SparseFiniteGP, y):
    """The ELBO of `y`, or of each column of a 2-D `y` (a loop: the blocked
    path's Functions and panel loops do not go through `torch.func.vmap`)."""
    approx = VFE(fxu.finducing)
    y = torch.as_tensor(y)
    if y.dim() == 2:
        return torch.stack([elbo(approx, fxu.fobs, y[:, j]) for j in range(y.shape[1])])
    return elbo(approx, fxu.fobs, y)


def rand_sparse(generator, fxu: SparseFiniteGP, num_samples=None):
    """Samples of a `SparseFiniteGP`: those of its observation FiniteGP."""
    return rand(generator, fxu.fobs, num_samples)

"""Distributed GPPP inference: the sharded counterparts of the dense verbs
for whole probabilistic programmes (counterpart of
`stheno_tpu/parallel/gppp.py`).

The reference writes the N×N covariance of the cov recursion with a row
sharding constraint and lets GSPMD push it back through the block assembly.
PyTorch has no such pass, so each rank asks the programme for its own rows
directly: `fx.f.cov2(rows_r(fx.x, a, b), fx.x)` plus its slab of the noise,
and its rows of the mean.  `rows_r` cuts a raw tensor, a `GPPPInput` or a
`BlockData` (across its blocks) to global rows [a, b).  Every programme
feature (sums, scalings, warps, tagged inputs, nonzero means) works
sharded, and K never exists on one rank.  The O(N³) work goes through the
distributed Cholesky and solves of `parallel.cholesky`.

Entry points (the programme, `y` and queries whole on every rank):

- `sharded_logpdf(mesh, fx, y)`: the exact log-marginal;
- `sharded_posterior(mesh, fx, y)`: a `ShardedPosteriorGP`, cross-process
  prediction (mean/var/cov at any tagged inputs) from the row-sharded
  factor;
- `sharded_rand(generator, mesh, fx)`: this rank's rows of a prior sample
  through the sharded factor (distributed L @ ε, ε drawn whole from the
  generator on every rank).
"""

from __future__ import annotations

import math

import torch

from stheno_tpu_torch.finite_gp import DiagNoise, FiniteGP, FullNoise, _add_diag
from stheno_tpu_torch.inputs import BlockData, GPPPInput, input_length
from stheno_tpu_torch.parallel.cholesky import (
    distributed_cholesky_auto,
    distributed_logdet_chol,
    distributed_lower_matvec,
    distributed_solve_lower,
    distributed_solve_upper_T,
)
from stheno_tpu_torch.parallel.collectives import Axis, psum, pvary_tree, shard
from stheno_tpu_torch.tree import frozen_dataclass, static_field


def _grouped(x):
    """A list of (name, point) pairs as the `BlockData` a GPPP makes of it
    (grouped by name in order of first appearance)."""
    grouped = {}
    for p, v in x:
        grouped.setdefault(p, []).append(v)
    return BlockData(*[GPPPInput(p, torch.stack([torch.as_tensor(v) for v in vs]))
                       for p, vs in grouped.items()])


def rows_r(x, a, b):
    """Global rows [a, b) of an input collection: a raw tensor, a
    `GPPPInput`, a `BlockData` (split across its blocks; blocks outside the
    range drop out) or a list of (name, point) pairs."""
    if isinstance(x, GPPPInput):
        return GPPPInput(x.p, rows_r(x.x, a, b))
    if isinstance(x, BlockData):
        out, start = [], 0
        for blk in x.blocks:
            n = input_length(blk)
            lo, hi = max(a, start), min(b, start + n)
            if lo < hi:
                out.append(rows_r(blk, lo - start, hi - start))
            start += n
        return BlockData(*out)
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], tuple):
        return rows_r(_grouped(x), a, b)
    return x[a:b]


def _noise_rows(noise, K_loc, a, b, n):
    """This rank's slab of the covariance plus its rows of the noise."""
    if isinstance(noise, FullNoise):
        return K_loc + noise.S[a:b].to(dtype=K_loc.dtype, device=K_loc.device)
    d = torch.as_tensor(noise.d)
    if d.dim() > 0:
        d = torch.broadcast_to(d, (n,))[a:b]
    return _add_diag(K_loc, d, a)


def sharded_cov(mesh, fx, axis_name="rows"):
    """This rank's (N/P, N) rows of `fx.cov()` (covariance + observation
    noise), computed from the programme directly."""
    ax = Axis(mesh, axis_name)
    n = len(fx)
    a, b = ax.rows(n)
    f = pvary_tree(fx, ax)
    if not isinstance(f.noise, (DiagNoise, FullNoise)):
        raise TypeError(f"unsupported noise {type(f.noise)}")
    K_loc = f.f.cov2(rows_r(f.x, a, b), f.x)
    return _noise_rows(f.noise, K_loc, a, b, n)


def sharded_chol(mesh, fx, block_size=512, axis_name="rows"):
    """This rank's rows of the lower Cholesky factor of `fx.cov()`
    (block-cyclic factorisation whenever divisibility allows)."""
    K = sharded_cov(mesh, fx, axis_name=axis_name)
    return distributed_cholesky_auto(mesh, K, block_size=block_size, axis_name=axis_name)


def _diff_rows(mesh, fx, y, L, axis_name):
    """This rank's rows of y − m."""
    ax = Axis(mesh, axis_name)
    a, b = ax.rows(len(fx))
    f = pvary_tree(fx, ax)
    m_loc = f.f.mean(rows_r(f.x, a, b))
    y = torch.as_tensor(y).to(dtype=L.dtype, device=L.device)
    return shard(y, ax) - m_loc


def sharded_logpdf(mesh, fx, y, block_size=512, axis_name="rows"):
    """Exact log N(y; m, K + Σ) of a GPPP or graph FiniteGP with every
    O(N²)+ object row-sharded (composite processes, nonzero means and
    tagged inputs: the covariance comes from the cov recursion)."""
    L = sharded_chol(mesh, fx, block_size=block_size, axis_name=axis_name)
    diff = _diff_rows(mesh, fx, y, L, axis_name)
    alpha = distributed_solve_lower(mesh, L, diff, block_size=block_size, axis_name=axis_name)
    logdet = distributed_logdet_chol(mesh, L, axis_name=axis_name)
    n = L.shape[1]
    return -0.5 * (n * math.log(2.0 * math.pi) + logdet + torch.sum(alpha * alpha))


def sharded_rand(generator, mesh, fx, block_size=512, axis_name="rows"):
    """This rank's rows of a draw y ~ N(m, K + Σ): m + L ε with ε (N,)
    standard normal from `generator` (a `torch.Generator` on the factor's
    device, seeded alike on every rank) and a distributed triangular
    matvec."""
    ax = Axis(mesh, axis_name)
    L = sharded_chol(mesh, fx, block_size=block_size, axis_name=axis_name)
    n = L.shape[1]
    a, b = ax.rows(n)
    eps = torch.randn((n,), generator=generator, dtype=L.dtype, device=L.device)
    f = pvary_tree(fx, ax)
    return f.f.mean(rows_r(f.x, a, b)) + distributed_lower_matvec(mesh, L, eps, axis_name=axis_name)


@frozen_dataclass(eq=False)
class ShardedPosteriorGP:
    """Posterior process conditioned through the distributed factorisation
    (`finite_gp.PosteriorGP` with the factor row-sharded): each prediction
    is two panel solves and a psum.  `x` may tag any process of the prior
    programme ("observe f3, read off f1")."""

    prior: object  # process-like (GPPP or graph node)
    x_obs: object
    L: torch.Tensor  # this rank's rows of chol(K_obs + Σ)
    alpha: torch.Tensor  # (K_obs + Σ)⁻¹ (y − m_obs), whole on every rank
    mesh: object = static_field()
    block_size: int = static_field(default=512)
    axis_name: str = static_field(default="rows")

    def _ax(self):
        return Axis(self.mesh, self.axis_name)

    def _k_ox(self, x):
        """This rank's rows of K(x_obs, x): (N/P, Np)."""
        ax = self._ax()
        a, b = ax.rows(input_length(self.x_obs))
        prior, x_obs, xq = pvary_tree((self.prior, self.x_obs, x), ax)
        return prior.cov2(rows_r(x_obs, a, b), xq)

    def _a(self, k):
        """L⁻¹ K(x_obs, x) from this rank's rows k = `_k_ox(x)`, whole on
        every rank ((N, Np); Np is a prediction batch, small next to N)."""
        return distributed_solve_lower(self.mesh, self.L, k, block_size=self.block_size,
                                       axis_name=self.axis_name)

    def _mean_term(self, k):
        """K(x, x_obs) α from this rank's rows k = `_k_ox(x)`."""
        ax = self._ax()
        return psum(k.T @ shard(self.alpha, ax), ax)

    def mean(self, x):
        return self.prior.mean(x) + self._mean_term(self._k_ox(x))

    def var(self, x):
        A = self._a(self._k_ox(x))
        return self.prior.var(x) - torch.sum(A * A, dim=0)

    def cov(self, x):
        A = self._a(self._k_ox(x))
        return self.prior.cov(x) - A.T @ A

    def cov2(self, x, x2):
        return self.prior.cov2(x, x2) - self._a(self._k_ox(x)).T @ self._a(self._k_ox(x2))

    def var2(self, x, x2):
        A, A2 = self._a(self._k_ox(x)), self._a(self._k_ox(x2))
        return self.prior.var2(x, x2) - torch.sum(A * A2, dim=0)

    def mean_and_var(self, x):
        # one cross slab (a cov recursion and a kernel-1 launch) for both
        k = self._k_ox(x)
        A = self._a(k)
        return self.prior.mean(x) + self._mean_term(k), self.prior.var(x) - torch.sum(A * A, dim=0)

    def mean_and_cov(self, x):
        k = self._k_ox(x)
        A = self._a(k)
        return self.prior.mean(x) + self._mean_term(k), self.prior.cov(x) - A.T @ A

    def __call__(self, x, noise=None):
        return FiniteGP(self, x, noise)


def sharded_posterior(mesh, fx, y, block_size=512, axis_name="rows"):
    """Condition `fx` on `y` (whole on every rank) through the distributed
    factorisation.  The factor stays row-sharded; predictions at Np points
    cost two distributed panel solves."""
    L = sharded_chol(mesh, fx, block_size=block_size, axis_name=axis_name)
    diff = _diff_rows(mesh, fx, y, L, axis_name)
    z = distributed_solve_lower(mesh, L, diff, block_size=block_size, axis_name=axis_name)
    alpha = distributed_solve_upper_T(mesh, L, z, block_size=block_size, axis_name=axis_name)
    return ShardedPosteriorGP(fx.f, fx.x, L, alpha, mesh=mesh, block_size=block_size,
                              axis_name=axis_name)

"""Big-N exact GPs: row-sharded kernel matrices and the distributed logpdf
(counterpart of `stheno_tpu/parallel/big.py`).

`sharded_kernelmatrix` computes this rank's (N/P, N) slab of K from the
whole O(N·D) input set, which every rank holds (the reference gathers it
with `all_gather`): kernel 1 on the card.  K never exists on one rank.

`big_gp_logpdf` = the sharded kernel rows + the distributed Cholesky + the
panel solve (`parallel.cholesky`): the exact log-marginal likelihood with
every O(N²) object sharded, differentiable in the kernel's
hyperparameters and the noise through the collectives.
"""

from __future__ import annotations

import math

import torch

from stheno_tpu_torch.finite_gp import _add_diag
from stheno_tpu_torch.ops.blocked_cholesky import _mm
from stheno_tpu_torch.parallel.cholesky import (
    distributed_cholesky_auto,
    distributed_logdet_chol,
    distributed_solve_lower,
)
from stheno_tpu_torch.parallel.collectives import Axis, pvary, pvary_tree, shard


def sharded_kernelmatrix(mesh, kernel, x, noise=None, axis_name="rows"):
    """This rank's rows of K(x, x) (+ noise·I): `x` (N,) or (N, D) whole on
    every rank; returns the (N/P, N) slab."""
    ax = Axis(mesh, axis_name)
    a, b = ax.rows(x.shape[0])
    x_all = pvary(x, ax)
    K_rows = pvary_tree(kernel, ax).matrix(x_all[a:b], x_all)
    if noise is not None:
        K_rows = _add_diag(K_rows, pvary(noise, ax), a)
    return K_rows


def sharded_matvec(mesh, K, v, axis_name="rows"):
    """This rank's rows of K v: K's slab against a whole v."""
    return _mm(K, pvary(v, Axis(mesh, axis_name)))


def big_gp_logpdf(mesh, kernel, x, y, noise, block_size=128, axis_name="rows"):
    """Exact log N(y; 0, K + σ²I) with every O(N²)+ object sharded; `x` and
    `y` whole on every rank.  The mean is zero (center y first)."""
    ax = Axis(mesh, axis_name)
    K = sharded_kernelmatrix(mesh, kernel, x, noise=noise, axis_name=axis_name)
    n = K.shape[1]
    L = distributed_cholesky_auto(mesh, K, block_size=block_size, axis_name=axis_name)
    del K
    alpha = distributed_solve_lower(mesh, L, shard(torch.as_tensor(y, dtype=L.dtype, device=L.device), ax),
                                    block_size=block_size, axis_name=axis_name)
    logdet = distributed_logdet_chol(mesh, L, axis_name=axis_name)
    return -0.5 * (n * math.log(2.0 * math.pi) + logdet + torch.sum(alpha * alpha))

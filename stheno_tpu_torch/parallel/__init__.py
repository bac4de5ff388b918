"""The distributed tier on `torch.distributed` (counterpart of
`stheno_tpu/parallel/`): mesh helpers, sharded chains and particles,
row-sharded kernel matrices with the distributed Cholesky, the sharded
GPPP verbs, the matrix-free ring and data-parallel SVGP.

Conventions (the reference is single-controller `shard_map`; here every
rank runs the whole program, SPMD):

1. A `P(axis)` argument or result of the reference is, on each rank, its
   local slab: rows [r·N/P, (r+1)·N/P) (the cyclic slots inside
   `distributed_cholesky_cyclic`).  A `P()` argument or result is the whole
   tensor on every rank.  The high-level entry points (`sharded_kernelmatrix`,
   `big_gp_logpdf`, `sharded_logpdf`, `sharded_posterior`, `sharded_rand`,
   `svgp_elbo_dp`, `run_smc_sharded`) take the global O(N·D) inputs on
   every rank and slice their own rows; the ring functions take what the
   reference's callers place with `shard_rows`: each rank's shard of `x`,
   `y` and `v`, with query points whole.  A mesh is a
   `torch.distributed.device_mesh.DeviceMesh` with named axes ("rows",
   "chains", "data"); `axis_name` selects the axis's process group.
2. Collectives are differentiable with `shard_map`'s varying/invariant
   gradient rules (`parallel.collectives`): `psum`'s backward is the
   identity, `all_gather`'s takes the rank's rows, `pvary` (the identity
   forward, an all-reduce backward) marks every replicated tensor that
   enters rank-local work, `ppermute` and `all_to_all` invert their
   exchange.  On every rank the gradient in a replicated hyperparameter is
   the single-process gradient, and the gradient in a sharded input is
   that rank's rows of it.  Each collective counts its calls.
3. Every GEMM of the panel loop, the solves and the ring goes through
   `ops.blocked_cholesky._mm`, as the reference's does: at the scoped
   `config.gemm_precision`, full FP32 (TF32 off) at the port's default
   'highest', 3xTF32 at 'high'.  Autograd differentiates the loops, and
   `_mm` below 'highest' is a Function whose backward runs at the same
   precision.

The meshes run on `cuda` (NCCL) unless the caller asks for `cpu` (gloo);
with no card a CUDA mesh raises, and a failed NCCL initialisation raises.
A one-rank mesh runs the same panel loop and collectives as a larger one.
"""

from stheno_tpu_torch.parallel.big import big_gp_logpdf, sharded_kernelmatrix, sharded_matvec
from stheno_tpu_torch.parallel.chains import run_nuts_sharded, run_smc_sharded
from stheno_tpu_torch.parallel.cholesky import (
    distributed_chol_solve,
    distributed_cholesky,
    distributed_cholesky_auto,
    distributed_cholesky_cyclic,
    distributed_logdet_chol,
    distributed_lower_matvec,
    distributed_mvn_logpdf,
    distributed_solve_lower,
    distributed_solve_upper_T,
)
from stheno_tpu_torch.parallel.gppp import (
    ShardedPosteriorGP,
    sharded_chol,
    sharded_cov,
    sharded_logpdf,
    sharded_posterior,
    sharded_rand,
)
from stheno_tpu_torch.parallel.mesh import chains_mesh, grid_mesh, rows_mesh, shard_rows
from stheno_tpu_torch.parallel.ring import (
    pcg_solve,
    ring_gp_solve,
    ring_matvec,
    ring_posterior_mean_var,
)
from stheno_tpu_torch.parallel.svgp import data_mesh, shard_batch, svgp_elbo_dp

__all__ = [
    "svgp_elbo_dp",
    "data_mesh",
    "shard_batch",
    "chains_mesh",
    "rows_mesh",
    "grid_mesh",
    "shard_rows",
    "run_nuts_sharded",
    "run_smc_sharded",
    "distributed_cholesky",
    "distributed_cholesky_auto",
    "distributed_cholesky_cyclic",
    "distributed_solve_lower",
    "distributed_solve_upper_T",
    "distributed_chol_solve",
    "distributed_logdet_chol",
    "distributed_lower_matvec",
    "distributed_mvn_logpdf",
    "sharded_cov",
    "sharded_chol",
    "sharded_logpdf",
    "sharded_rand",
    "sharded_posterior",
    "ShardedPosteriorGP",
    "sharded_kernelmatrix",
    "sharded_matvec",
    "big_gp_logpdf",
    "ring_matvec",
    "pcg_solve",
    "ring_gp_solve",
    "ring_posterior_mean_var",
]

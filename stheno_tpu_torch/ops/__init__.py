from stheno_tpu_torch.ops.chol import (
    chol_logdet,
    chol_solve,
    cholesky_psd,
    mvn_logpdf_chol,
    mvn_logpdf_psd,
    mvn_sample_chol,
    solve_lower,
    solve_upper,
)
from stheno_tpu_torch.ops.pairwise import (
    ensure_2d,
    pairwise_dist,
    pairwise_dot,
    pairwise_sqdist,
    sqdist_diag,
)

__all__ = [
    "chol_logdet", "chol_solve", "cholesky_psd", "mvn_logpdf_chol",
    "mvn_logpdf_psd", "mvn_sample_chol", "solve_lower", "solve_upper", "ensure_2d",
    "pairwise_dist", "pairwise_dot", "pairwise_sqdist", "sqdist_diag",
]

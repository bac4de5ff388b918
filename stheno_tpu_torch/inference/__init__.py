"""Inference engines (counterpart of `stheno_tpu/inference/`).

Ported so far: `vi`, the optimisation loops over a constrained parameter
spec (`fit` with Adam, `fit_lbfgs`).
"""

from stheno_tpu_torch.inference.vi import FitResult, fit, fit_lbfgs

__all__ = ["FitResult", "fit", "fit_lbfgs"]

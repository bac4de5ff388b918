"""Inference engines (counterpart of `stheno_tpu/inference/`).

Ported so far:

- `vi`: the optimisation loops over a constrained parameter spec (`fit`
  with Adam, `fit_lbfgs`);
- `svgp`: the uncollapsed minibatch bound with inducing points;
- `likelihoods`: Gaussian, Bernoulli, Poisson and Student-t observation
  models;
- `laplace`: the Laplace approximation for non-Gaussian likelihoods.
"""

from stheno_tpu_torch.inference.laplace import LaplacePosteriorGP, LaplaceResult, laplace
from stheno_tpu_torch.inference.likelihoods import (
    BernoulliLikelihood,
    GaussianLikelihood,
    Likelihood,
    PoissonLikelihood,
    StudentTLikelihood,
)
from stheno_tpu_torch.inference.svgp import (
    SVGP,
    SVGPPosteriorGP,
    svgp_elbo,
    svgp_init,
    svgp_optimal_gaussian,
    svgp_posterior,
)
from stheno_tpu_torch.inference.vi import FitResult, fit, fit_lbfgs

__all__ = [
    "SVGP", "svgp_init", "svgp_elbo", "svgp_posterior", "svgp_optimal_gaussian",
    "SVGPPosteriorGP", "fit", "fit_lbfgs", "FitResult", "Likelihood", "GaussianLikelihood",
    "BernoulliLikelihood", "PoissonLikelihood", "StudentTLikelihood", "laplace",
    "LaplaceResult", "LaplacePosteriorGP",
]

"""Inference engines (counterpart of `stheno_tpu/inference/`).

Ported so far:

- `vi`: the optimisation loops over a constrained parameter spec (`fit`
  with Adam, `fit_lbfgs`);
- `svgp`: the uncollapsed minibatch bound with inducing points;
- `likelihoods`: Gaussian, Bernoulli, Poisson and Student-t observation
  models;
- `laplace`: the Laplace approximation for non-Gaussian likelihoods;
- `hmc`: NUTS and HMC over batched chains, with Stan window adaptation,
  segmented warmup and resumable sampling;
- `smc`: adaptive-tempering SMC with systematic resampling;
- `diagnostics`: split-R̂ and bulk ESS;
- `checkpoint`: sampler state to disk and back.
"""

from stheno_tpu_torch.inference.checkpoint import checkpoint_step, load_checkpoint, save_checkpoint
from stheno_tpu_torch.inference.diagnostics import effective_sample_size, potential_scale_reduction
from stheno_tpu_torch.inference.hmc import (
    ChainState,
    NUTSInfo,
    WarmupState,
    hmc_kernel,
    nuts_kernel,
    nuts_warmup,
    run_nuts,
    warmup_result,
)
from stheno_tpu_torch.inference.laplace import LaplacePosteriorGP, LaplaceResult, laplace
from stheno_tpu_torch.inference.likelihoods import (
    BernoulliLikelihood,
    GaussianLikelihood,
    Likelihood,
    PoissonLikelihood,
    StudentTLikelihood,
)
from stheno_tpu_torch.inference.smc import (
    SMCCheckpoint,
    SMCResult,
    run_smc,
    smc_finished,
    smc_init,
    smc_result,
    smc_segment,
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
    "LaplaceResult", "LaplacePosteriorGP", "nuts_kernel", "hmc_kernel", "run_nuts", "nuts_warmup",
    "warmup_result", "WarmupState", "NUTSInfo", "ChainState", "save_checkpoint", "load_checkpoint",
    "checkpoint_step", "run_smc", "smc_init", "smc_segment", "smc_finished", "smc_result",
    "SMCCheckpoint", "SMCResult", "effective_sample_size", "potential_scale_reduction",
]

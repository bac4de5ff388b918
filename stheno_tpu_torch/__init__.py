"""stheno_tpu_torch — the PyTorch/CUDA port of stheno_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module names where that
helps a reader find the counterpart.  It imports neither JAX nor anything of
`stheno_tpu`.  The three Pallas kernels of the JAX package are CUDA kernels
here (`stheno_tpu_torch.cuda`), built with nvcc for `sm_90a` at first use;
on a CPU tensor each runs its plain PyTorch version.

Ported so far: the exact-GP path of a GPPP on the blocked Cholesky with
its closed-form reverse rule —

- the kernel zoo with its algebra (SE and Matern12/32/52 on kernel 1, the
  rest in plain PyTorch, as the reference computes them on XLA);
- the process graph: atomic, sum and scaled processes, constant and
  function shifts and scalings, input warps (`stretch`, `select`,
  `periodic`, `shift`, `compose`), `additive_gp`, wrapped leaves
  (`atomic`) and `cross`;
- GPPP queries at one process (`GPPPInput`), at several jointly
  (`BlockData`, `[(name, x), ...]`), and across them;
- `logpdf` with its gradient, `rand`, `posterior` and `marginals`, and the
  fused logpdf with its closed-form gradient (`config.logpdf_fused`);
- pseudo-point inference: `VFE` with the collapsed bound `elbo`, the
  approximate posterior `posterior_vfe`, `SparseFiniteGP`, with inducing
  points in any process of a GPPP (interdomain);
- constrained parameters (`params`) and the fitting loops
  (`inference.fit`, `inference.fit_lbfgs`); SVGP, the likelihoods and the
  Laplace approximation (`inference`);
- the five BASELINE model families (`models`), the conformance checks
  (`utils.testing`), and the state-space tier (`markov`);
- derivative processes (`derivative`, exact by nested `torch.func.jvp`
  through kernel 1's forward-mode rule), quadrature convolutions
  (`convolve_quadrature`), the Neural Kernel Network (`kernels.nkn`) and
  pathwise sampling (`sampling`: random Fourier features and Matheron's
  update).
"""

from stheno_tpu_torch import config
from stheno_tpu_torch.finite_gp import (
    VFE,
    ApproxPosteriorGP,
    DiagNoise,
    FiniteGP,
    FullNoise,
    Marginals,
    PosteriorGP,
    SparseFiniteGP,
    cov,
    elbo,
    elbo_fx,
    logpdf,
    marginals,
    mean,
    mean_and_cov,
    mean_and_var,
    posterior,
    posterior_vfe,
    rand,
    var,
)
from stheno_tpu_torch.gppp import GPPP, gppp
from stheno_tpu_torch.graph import (
    GP,
    GPC,
    AbstractProcess,
    AddConstGP,
    AddFnGP,
    AtomicGP,
    CompositeGP,
    ConvolvedGP,
    CrossGP,
    DerivativeGP,
    FnWarp,
    ParamFn,
    Periodic,
    ScaledFnGP,
    ScaledGP,
    Select,
    Shift,
    StaticFn,
    Stretch,
    SumGP,
    WrappedGP,
    additive_gp,
    atomic,
    compose,
    convolve_quadrature,
    cross,
    cross_cov,
    cross_var,
    derivative,
    periodic,
    select,
    shift,
    stretch,
)
from stheno_tpu_torch.inputs import (
    BlockData,
    ColVecs,
    GPPPInput,
    RowVecs,
    input_length,
    split,
    vcat,
)
from stheno_tpu_torch.kernels import *  # noqa: F401,F403
from stheno_tpu_torch.kernels import __all__ as _kernels_all
from stheno_tpu_torch.markov import (
    markov_gp_logpdf,
    markov_gp_posterior_marginals,
    sde_representation,
)
from stheno_tpu_torch.means import ConstMean, FunctionMean, ZeroMean
from stheno_tpu_torch.sampling import (
    pathwise_conditioned_samples,
    prior_samples,
    spectral_features,
)

#: The reference's full name of a GPPP.
GaussianProcessProbabilisticProgramme = GPPP

__all__ = list(_kernels_all) + [
    "config", "DiagNoise", "FiniteGP", "FullNoise", "Marginals", "PosteriorGP",
    "cov", "logpdf", "marginals", "mean", "mean_and_cov", "mean_and_var",
    "posterior", "rand", "var", "VFE", "elbo", "elbo_fx", "posterior_vfe",
    "ApproxPosteriorGP", "SparseFiniteGP", "GPPP", "gppp", "GaussianProcessProbabilisticProgramme",
    "GP", "GPC", "AbstractProcess", "AddConstGP", "AddFnGP", "AtomicGP", "CompositeGP",
    "CrossGP", "FnWarp", "ParamFn", "Periodic", "ScaledFnGP", "ScaledGP", "Select",
    "Shift", "StaticFn", "Stretch", "SumGP", "WrappedGP", "additive_gp", "atomic",
    "compose", "cross", "cross_cov", "cross_var", "periodic", "select", "shift",
    "stretch", "BlockData", "ColVecs", "GPPPInput", "RowVecs", "input_length", "split",
    "vcat", "ConstMean", "FunctionMean", "ZeroMean", "ConvolvedGP", "DerivativeGP",
    "convolve_quadrature", "derivative", "markov_gp_logpdf", "markov_gp_posterior_marginals",
    "sde_representation", "pathwise_conditioned_samples", "prior_samples", "spectral_features",
]

"""Pathwise sampling (counterpart of `stheno_tpu/sampling.py`): functional
prior draws from random Fourier features, and Matheron's update.

1. **Prior samples as functions.**  Each atomic leaf of a process graph gets
   a random-Fourier-feature basis drawn from its kernel's spectral measure,
   and a prior draw is f_s(·) = m(·) + Σ_i w_si φ_i(·) with w ~ N(0, I).
   The graph is affine, so a joint draw of a whole programme composes the
   leaf draws through it: sums add sample functions, scalings multiply,
   warps re-index, derivatives differentiate the sample path (exactly, by
   `torch.func.jvp`), convolutions take its quadrature.  Each leaf is drawn
   once and shared, so every correlation between processes is kept.
2. **Pathwise conditioning** (Wilson et al. 2020): given y = f(X) + ε,

       f_s|y(·) = f_s(·) + K(·, X)(K + Σ)⁻¹(y − f_s(X) − ε_s),

   S prior draws become S posterior draws with one factor of K + Σ
   (`ops.chol.cholesky_psd`: the blocked path through kernels 2 and 3 at
   N ≥ 4096 in f32 on the card); evaluating them at n new points is then
   one (N, n) cross-covariance (kernel 1) and one GEMM.

Random numbers.  The reference splits a JAX key; here every draw (ω, the
phases, the weights and the noise) comes, in a fixed order, from one numpy
`Generator` (`rng`: a Generator or an integer seed) on the host in f64, and
is then cast to the dtype and moved to the device asked for.  The arrays
are small (F × d, S × F, S × N), numpy has the t and gamma draws that
`torch.distributions` takes no generator for, and one seed gives the same
paths on the CPU and on the card.  The draws cannot match the reference's
bit for bit; `convert.fourier_basis_from_numpy` carries its own draws over.

Accuracy: exact in distribution up to the O(1/√F) error of the features.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stheno_tpu_torch import graph as _g
from stheno_tpu_torch.inputs import input_device, input_dtype
from stheno_tpu_torch.kernels import base as _kb
from stheno_tpu_torch.kernels import zoo as _kz
from stheno_tpu_torch.ops import chol as _chol
from stheno_tpu_torch.ops.pairwise import ensure_2d
from stheno_tpu_torch.tree import frozen_dataclass, static_field

__all__ = [
    "FourierBasis", "spectral_features", "prior_samples", "PriorFunctionSamples",
    "pathwise_conditioned_samples", "PosteriorFunctionSamples",
]


def _rng(rng):
    """A numpy Generator from a Generator or an integer seed."""
    return rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)


@frozen_dataclass
class FourierBasis:
    """φ_i(x) = scale_i · cos(ω_iᵀ t(x) + b_i), with E[φ(x)ᵀφ(y)] = k(x, y).

    `transform` composes the non-linear input transforms found while
    descending the kernel (a lengthscale over linear features is folded
    into ω)."""

    omega: torch.Tensor  # (F, d)
    phase: torch.Tensor  # (F,)
    scale: torch.Tensor  # (F,)
    transform: object = static_field(default=None)

    @property
    def num_features(self):
        return self.omega.shape[0]

    def __call__(self, x):
        if self.transform is not None:
            x = self.transform(x)
        proj = ensure_2d(x) @ self.omega.T + self.phase[None, :]
        return torch.cos(proj) * self.scale[None, :]


def _matern_omega(rng, num_features, dim, nu):
    """ω ~ t_{2ν}(0, I): the Matérn-ν spectral measure at unit lengthscale
    in this zoo's convention (S(ω) ∝ (2ν + ‖ω‖²)^{−(ν + D/2)}), as a normal
    over the root of a χ²_{2ν}/2ν."""
    z = rng.standard_normal((num_features, dim))
    df = 2.0 * nu
    u = 2.0 * rng.standard_gamma(df / 2.0, (num_features, 1))
    return z * np.sqrt(df / u)


def spectral_features(kernel, rng, num_features, input_dim=1, dtype=None, device=None):
    """Draw a `FourierBasis` from `kernel`'s spectral measure, its numbers
    from `rng` (a numpy Generator or a seed), of `dtype` (default: torch's)
    on `device` (default: the CPU).

    Supported: SE, Matérn-1/2, 3/2 and 5/2, RationalQuadratic, Cosine, and
    any scaling, lengthscale, sum, product or non-linear input transform of
    them.  Other kernels have no translation-invariant spectral measure and
    raise NotImplementedError."""
    rng = _rng(rng)
    dt = dtype or torch.get_default_dtype()
    dev = torch.device(device or "cpu")
    F, d = num_features, input_dim

    def tensor(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    if isinstance(kernel, _kz.SEKernel):
        om = rng.standard_normal((F, d))
    elif isinstance(kernel, _kz.Matern12Kernel):
        om = _matern_omega(rng, F, d, 0.5)
    elif isinstance(kernel, _kz.Matern32Kernel):
        om = _matern_omega(rng, F, d, 1.5)
    elif isinstance(kernel, _kz.Matern52Kernel):
        om = _matern_omega(rng, F, d, 2.5)
    elif isinstance(kernel, _kz.RationalQuadraticKernel):
        # RQ is a Gamma(α, rate α) scale mixture of SE over the precision
        alpha = float(kernel.alpha)
        z = rng.standard_normal((F, d))
        om = z * np.sqrt(rng.standard_gamma(alpha, (F, 1)) / alpha)
    elif isinstance(kernel, _kz.CosineKernel):
        # a line spectrum at ±π; cos(π‖x − y‖) for d > 1 is not cos(πΣdx_i),
        # and has no product spectral measure
        if d > 1:
            raise NotImplementedError("CosineKernel spectral basis is only defined for 1-D inputs")
        om = np.full((F, d), math.pi)
    elif isinstance(kernel, _kb.ScaledKernel):
        base = spectral_features(kernel.kernel, rng, F, d, dt, dev)
        return FourierBasis(base.omega, base.phase,
                            base.scale * torch.sqrt(tensor(kernel.variance)), base.transform)
    elif isinstance(kernel, _kb.TransformedKernel):
        t = kernel.transform
        base = spectral_features(kernel.kernel, rng, F, d, dt, dev)
        if isinstance(t, _kb._LengthscaleTransform):
            ell = tensor(t.lengthscale)
            if base.transform is None:
                # k(x/ℓ, y/ℓ) with linear features: fold 1/ℓ into ω exactly
                om = base.omega / (ell if ell.dim() == 0 else ell[None, :])
                return FourierBasis(om, base.phase, base.scale, None)
            # cos(ωᵀT(x/ℓ)) ≠ cos((ω/ℓ)ᵀT(x)): divide the input instead
            inner = base.transform
            return FourierBasis(base.omega, base.phase, base.scale,
                                lambda x, _i=inner, _e=ell: _i(torch.as_tensor(x) / _e))
        inner = base.transform
        tf = t if inner is None else (lambda x, _t=t, _i=inner: _i(_t(x)))
        return FourierBasis(base.omega, base.phase, base.scale, tf)
    elif isinstance(kernel, _kb.SumKernel):
        f1 = F // 2
        b1 = spectral_features(kernel.left, rng, f1, d, dt, dev)
        b2 = spectral_features(kernel.right, rng, F - f1, d, dt, dev)
        if b1.transform is not None or b2.transform is not None:
            raise NotImplementedError("sum of input-transformed kernels in one spectral basis")
        # each block is normalised by its own F, so the concatenation is exact
        return FourierBasis(torch.cat([b1.omega, b2.omega]), torch.cat([b1.phase, b2.phase]),
                            torch.cat([b1.scale, b2.scale]), None)
    elif isinstance(kernel, _kb.ProductKernel):
        # the spectral measure of a product is the convolution: ω = ω₁ + ω₂
        b1 = spectral_features(kernel.left, rng, F, d, dt, dev)
        b2 = spectral_features(kernel.right, rng, F, d, dt, dev)
        if b1.transform is not None or b2.transform is not None:
            raise NotImplementedError("product of input-transformed kernels in one spectral basis")
        # scale_i = √(2vᵢ/F) each, and the product needs √(2v₁v₂/F)
        return FourierBasis(b1.omega + b2.omega, b1.phase,
                            b1.scale * b2.scale * math.sqrt(F / 2.0), None)
    else:
        raise NotImplementedError(
            f"no spectral measure for {type(kernel).__name__}; pathwise sampling supports "
            "stationary kernels (SE/Matérn/RQ/Cosine and their algebra)")

    phase = rng.uniform(0.0, 2.0 * math.pi, F)
    return FourierBasis(tensor(om), tensor(phase), tensor(np.full(F, math.sqrt(2.0 / F))), None)


class PriorFunctionSamples:
    """S joint functional draws of a process or a whole programme.

    Called with raw inputs (a process) or tagged ones (`GPPPInput`,
    `BlockData` of a GPPP), it returns the (S, n) sample-path values; one
    object evaluates one coherent set of paths at any inputs, of any
    process of the programme."""

    def __init__(self, root, leaf_draws, num_samples):
        self._root = root
        self._leaf = leaf_draws  # node index → (basis, weights (S, F), mean function)
        self.num_samples = num_samples

    def __call__(self, x):
        return self._eval(self._root, x)

    def _eval(self, f, x):
        from stheno_tpu_torch.gppp import GPPP

        if isinstance(f, GPPP):
            node, v = f.extract(x)
            return self._eval(node, v)
        if isinstance(f, _g.AtomicGP):
            basis, w, mean_fn = self._leaf[f.n]
            return mean_fn(x)[None, :] + w @ basis(x).T
        if isinstance(f, _g.SumGP):
            return self._eval(f.left, x) + self._eval(f.right, x)
        if isinstance(f, _g.AddConstGP):
            return f.b + self._eval(f.f, x)
        if isinstance(f, _g.AddFnGP):
            return torch.as_tensor(f.b(torch.as_tensor(x)))[None, :] + self._eval(f.f, x)
        if isinstance(f, _g.ScaledGP):
            return f.sigma * self._eval(f.f, x)
        if isinstance(f, _g.ScaledFnGP):
            return f._s(x)[None, :] * self._eval(f.f, x)
        if isinstance(f, _g.CompositeGP):
            return self._eval(f.f, f.warp(x))
        if isinstance(f, _g.ConvolvedGP):
            return self._eval(f.f, f.nodes) @ f._w(x).T
        if isinstance(f, _g.DerivativeGP):
            return _g._jvp_ones(lambda xx: self._eval(f.f, xx), x)
        if isinstance(f, _g.CrossGP):
            return torch.cat([self._eval(fi, b) for fi, b in zip(f.fs, f._blocks(x))], dim=1)
        raise NotImplementedError(f"pathwise sampling through {type(f).__name__}")


_UNARY_NODES = (_g.AddConstGP, _g.AddFnGP, _g.ScaledGP, _g.ScaledFnGP, _g.CompositeGP,
                _g.ConvolvedGP, _g.DerivativeGP)


def _collect_atomics(f, out):
    from stheno_tpu_torch.gppp import GPPP

    if isinstance(f, GPPP):
        for p in f.processes.values():
            _collect_atomics(p, out)
    elif isinstance(f, _g.AtomicGP):
        out[f.n] = f
    elif isinstance(f, _g.SumGP):
        _collect_atomics(f.left, out)
        _collect_atomics(f.right, out)
    elif isinstance(f, _g.CrossGP):
        for fi in f.fs:
            _collect_atomics(fi, out)
    elif isinstance(f, _UNARY_NODES):
        _collect_atomics(f.f, out)
    else:
        raise NotImplementedError(f"pathwise sampling through {type(f).__name__}")


def prior_samples(f, rng, num_samples, num_features=1024, input_dim=1, dtype=None,
                  device=None):
    """S functional prior draws of the process or programme `f` (RFF), of
    `dtype` (default: torch's) on `device` (default: the CPU), their
    numbers from `rng` (a numpy Generator or a seed).  Every atomic leaf
    gets one shared basis and weight draw, in the order of the leaves'
    indices, so evaluations at any inputs of any (derived) process are
    samples of the joint prior.  Returns a `PriorFunctionSamples`."""
    rng = _rng(rng)
    leaves = {}
    _collect_atomics(f, leaves)
    if not leaves:
        raise ValueError("no atomic leaves found to sample")
    draws = {}
    for nid, leaf in sorted(leaves.items()):
        basis = spectral_features(leaf.kernel, rng, num_features, input_dim, dtype, device)
        w = torch.as_tensor(rng.standard_normal((num_samples, basis.num_features)),
                            dtype=basis.omega.dtype, device=basis.omega.device)
        draws[nid] = (basis, w, leaf.mean)
    return PriorFunctionSamples(f, draws, num_samples)


class PosteriorFunctionSamples:
    """S coherent posterior function draws, f_s(·) + K(·, X) v_s."""

    def __init__(self, prior_fn, fx, V):
        self._prior = prior_fn
        self._fx = fx
        self._V = V  # (N, S)
        self.num_samples = prior_fn.num_samples

    def __call__(self, x):
        from stheno_tpu_torch.finite_gp import _cross_cov_any

        Kxs = _cross_cov_any(self._fx.f, self._fx.x, self._fx.f, x)  # (N, n)
        return self._prior(x) + self._V.T @ Kxs


def _noise_draws(fx, rng, num_samples, like):
    """ε_s ~ N(0, Σ) of `fx`'s noise, (S, N) like `like`."""
    from stheno_tpu_torch.finite_gp import DiagNoise, FullNoise, _like

    n = like.shape[1]
    z = torch.as_tensor(rng.standard_normal((num_samples, n)), dtype=like.dtype, device=like.device)
    if isinstance(fx.noise, DiagNoise):
        return torch.sqrt(_like(fx.noise.diag(n), like))[None, :] * z
    if isinstance(fx.noise, FullNoise):
        return z @ _chol.cholesky_psd(_like(fx.noise.S, like)).T
    raise TypeError(f"unsupported noise {type(fx.noise).__name__}")  # pragma: no cover


def _condition(prior_fn, fx, y, F_X, eps):
    """Matheron's update of the prior draws `prior_fn`, whose values at fx.x
    are `F_X` (S, N), given y of `fx` and the noise draws `eps` (S, N): one
    factor of K + Σ."""
    from stheno_tpu_torch.finite_gp import _like

    L = _chol.cholesky_psd(fx.cov())
    resid = (_like(y, F_X)[None, :] - F_X - eps).T  # (N, S)
    return PosteriorFunctionSamples(prior_fn, fx, _chol.chol_solve(L, resid))


def pathwise_conditioned_samples(fx, y, rng, num_samples, num_features=1024, input_dim=1,
                                 dtype=None):
    """S posterior function draws given observations `y` of `fx` = f(X, Σ),
    by Matheron's rule on RFF prior paths (Wilson et al. 2020, eq. 13):

        f_s|y(·) = f_s(·) + K(·, X)(K + Σ)⁻¹(y − f_s(X) − ε_s),  ε_s ~ N(0, Σ).

    One factor of K + Σ in all; each evaluation afterwards is one (N, n)
    cross-covariance and one GEMM, and works across the processes of a
    GPPP (observe f3, evaluate the same draw on f1).  The draws take
    `dtype` (default: the inputs') on the inputs' device; their numbers
    come from `rng` (a numpy Generator or a seed), the prior's first."""
    rng = _rng(rng)
    dt = dtype or input_dtype(fx.x)
    prior_fn = prior_samples(fx.f, rng, num_samples, num_features, input_dim, dt,
                             input_device(fx.x))
    F_X = prior_fn(fx.x)
    eps = _noise_draws(fx, rng, num_samples, F_X)
    return _condition(prior_fn, fx, y, F_X, eps)

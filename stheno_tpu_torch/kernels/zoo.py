"""The kernel zoo (counterpart of `stheno_tpu/kernels/zoo.py`).

- `StationaryKernel`: SE and Matern12/32/52, with the KernelFunctions.jl
  aliases.  Full matrices go through kernel 1 (`cuda/kernelmatrix.py`),
  which takes the variance and writes the same-input diagonal as exactly
  k(0); the O(N) diagonal paths apply the same epilogue elementwise.
- `DistanceKernel`: the other functions of the distance (RationalQuadratic,
  GammaExponential, Cosine).  The reference computes them on its XLA path,
  not in Pallas, so here they are plain PyTorch on the distance ops, with
  the same-input diagonal pinned to k(0).
- Periodic, White, Constant, Zero, Linear, Polynomial, Exponentiated,
  Wiener, FBM and NeuralNetwork: plain PyTorch, as in the reference.

`DiagNoise.add_to` writes the noise into a covariance in place, so every
`matrix` here returns a fresh tensor that is not expanded, made by an op
that does not save its output for backward.  Where the last op would be an
exp, which does (∂eˣ = eˣ), `_exp` saves its input instead.
"""

from __future__ import annotations

import torch

import math

from stheno_tpu_torch.cuda.kernelmatrix import epilogue, kernelmatrix
from stheno_tpu_torch.func_transforms import lowered_jvp
from stheno_tpu_torch.kernels.base import Kernel
from stheno_tpu_torch.ops import pairwise
from stheno_tpu_torch.tree import frozen_dataclass, static_field


def _variance_like(variance, x):
    if torch.is_tensor(variance):
        return variance.to(dtype=x.dtype, device=x.device)
    return torch.tensor(variance, dtype=x.dtype, device=x.device)


class _Exp(torch.autograd.Function):
    """eˣ that saves x, not its output, for backward, so the caller may add
    into the output in place (the backward recomputes eˣ).  Under
    `torch.func.vmap` its rule is generated: it is elementwise.  Its
    forward-mode rule ṫ·eᵗ runs through `lowered_jvp`, so nested jvps and
    reverse mode differentiate it again."""

    generate_vmap_rule = True

    @staticmethod
    def forward(t):
        return torch.exp(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (t,) = ctx.saved_tensors
        return g * torch.exp(t)

    @staticmethod
    def jvp(ctx, t_dot):
        (t,) = ctx.saved_tensors
        return lowered_jvp(lambda a, a_dot: a_dot * torch.exp(a), t, t_dot)


def _exp(t):
    return _Exp.apply(t)


def _dtype_device(x, y):
    """Promoted float dtype and device of two input sets (N,[D])."""
    x2, y2 = pairwise.ensure_2d(x), pairwise.ensure_2d(y)
    return torch.promote_types(x2.dtype, y2.dtype), x2.device


class StationaryKernel(Kernel):
    """Kernel that is a function of the squared distance, named by `kind`
    (a key of `cuda.kernelmatrix.KINDS`)."""

    kind = None

    def scaled(self, x, y, variance):
        x = pairwise.ensure_2d(x).contiguous()
        y = None if y is None else pairwise.ensure_2d(y).contiguous()
        return kernelmatrix(x, y, self.kind, _variance_like(variance, x))

    def matrix(self, x, y):
        return self.scaled(x, y, 1.0)

    def matrix_same(self, x):
        return self.scaled(x, None, 1.0)

    def diag(self, x, y):
        return epilogue(self.kind, pairwise.sqdist_diag(x, y))

    def diag_same(self, x):
        x = pairwise.ensure_2d(x)
        return epilogue(self.kind, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device))


@frozen_dataclass
class SEKernel(StationaryKernel):
    """Squared-exponential: exp(-‖x − y‖² / 2)."""

    kind = "se"


SqExponentialKernel = SEKernel
RBFKernel = SEKernel
GaussianKernel = SEKernel


@frozen_dataclass
class Matern12Kernel(StationaryKernel):
    """exp(-‖x − y‖), a.k.a. the exponential kernel."""

    kind = "matern12"


ExponentialKernel = Matern12Kernel


@frozen_dataclass
class Matern32Kernel(StationaryKernel):
    """(1 + √3 d) exp(-√3 d)."""

    kind = "matern32"


@frozen_dataclass
class Matern52Kernel(StationaryKernel):
    """(1 + √5 d + 5 d²/3) exp(-√5 d)."""

    kind = "matern52"


class DistanceKernel(Kernel):
    """Kernel that is a function of the distance, in plain PyTorch on the
    distance ops (the reference's XLA path, `zoo.py:25-66`).  Subclasses
    implement `_from_sqdist(sq)`, or `_from_dist(d)` with d = ‖x − y‖ taken
    under the masked-sqrt convention (gradient 0 at d = 0)."""

    def _from_sqdist(self, sq):
        eps = torch.finfo(sq.dtype).eps ** 2
        d = torch.sqrt(torch.clamp(sq, min=eps)) * (sq > 0)
        return self._from_dist(d)

    def _from_dist(self, d):  # pragma: no cover - interface
        raise NotImplementedError

    def matrix(self, x, y):
        return self._from_sqdist(pairwise.pairwise_sqdist(x, y))

    def diag(self, x, y):
        return self._from_sqdist(pairwise.sqdist_diag(x, y))

    def matrix_same(self, x):
        # the diagonal pinned to exactly zero distance (value and gradient)
        sq = pairwise.pairwise_sqdist(x, x)
        sq.fill_diagonal_(0.0)
        return self._from_sqdist(sq)

    def diag_same(self, x):
        x = pairwise.ensure_2d(x)
        return self._from_sqdist(torch.zeros(x.shape[0], dtype=x.dtype, device=x.device))


@frozen_dataclass
class RationalQuadraticKernel(DistanceKernel):
    """(1 + d²/(2α))^(−α)."""

    alpha: object

    def _from_sqdist(self, sq):
        return _exp(-self.alpha * torch.log1p(sq / (2.0 * self.alpha)))


@frozen_dataclass
class GammaExponentialKernel(DistanceKernel):
    """exp(−d^γ), γ ∈ (0, 2]."""

    gamma: object

    def _from_dist(self, d):
        return _exp(-(d**self.gamma))


@frozen_dataclass
class CosineKernel(DistanceKernel):
    """cos(π ‖x − y‖)."""

    def _from_dist(self, d):
        return torch.cos(math.pi * d)


@frozen_dataclass
class PeriodicKernel(Kernel):
    """exp(−½ Σ_d (sin(π (x_d − y_d)) / r_d)²), the KernelFunctions.jl form
    (the `periodic` input warp of `graph.py` is the other route)."""

    r: object

    def _from_diff(self, dx):
        s = torch.sin(math.pi * dx) / self.r
        return _exp(-0.5 * torch.sum(s * s, dim=-1))

    def matrix(self, x, y):
        x, y = pairwise.ensure_2d(x), pairwise.ensure_2d(y)
        return self._from_diff(x[:, None, :] - y[None, :, :])

    def diag(self, x, y):
        return self._from_diff(pairwise.ensure_2d(x) - pairwise.ensure_2d(y))

    def diag_same(self, x):
        x = pairwise.ensure_2d(x)
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)


@frozen_dataclass
class WhiteKernel(Kernel):
    """δ(x == y): cross entries compare input values elementwise; the
    same-input matrix of distinct points is the identity."""

    def matrix(self, x, y):
        x2, y2 = pairwise.ensure_2d(x), pairwise.ensure_2d(y)
        dt, _ = _dtype_device(x, y)
        return torch.all(x2[:, None, :] == y2[None, :, :], dim=-1).to(dt)

    def diag(self, x, y):
        x2, y2 = pairwise.ensure_2d(x), pairwise.ensure_2d(y)
        return torch.all(x2 == y2, dim=-1).to(x2.dtype)

    def matrix_same(self, x):
        x = pairwise.ensure_2d(x)
        return torch.eye(x.shape[0], dtype=x.dtype, device=x.device)

    def diag_same(self, x):
        x = pairwise.ensure_2d(x)
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)


@frozen_dataclass
class ConstantKernel(Kernel):
    """k(x, y) = c, as a dense matrix of the inputs' dtype (the reference's
    `broadcast_to` view would be written through by an in-place noise)."""

    c: object

    def _fill(self, shape, x, y):
        dt, dev = _dtype_device(x, y)
        c = self.c.to(dtype=dt, device=dev) if torch.is_tensor(self.c) else torch.tensor(
            self.c, dtype=dt, device=dev)
        return c.expand(shape).clone(memory_format=torch.contiguous_format)

    def matrix(self, x, y):
        return self._fill((pairwise.ensure_2d(x).shape[0], pairwise.ensure_2d(y).shape[0]), x, y)

    def diag(self, x, y):
        return self._fill((pairwise.ensure_2d(x).shape[0],), x, y)


@frozen_dataclass
class ZeroKernel(Kernel):
    """k(x, y) = 0."""

    def matrix(self, x, y):
        dt, dev = _dtype_device(x, y)
        return torch.zeros((pairwise.ensure_2d(x).shape[0], pairwise.ensure_2d(y).shape[0]),
                           dtype=dt, device=dev)

    def diag(self, x, y):
        dt, dev = _dtype_device(x, y)
        return torch.zeros(pairwise.ensure_2d(x).shape[0], dtype=dt, device=dev)


@frozen_dataclass
class LinearKernel(Kernel):
    """k(x, y) = ⟨x, y⟩ + c."""

    c: object = 0.0

    def matrix(self, x, y):
        return pairwise.pairwise_dot(x, y) + self.c

    def diag(self, x, y):
        return pairwise.dot_diag(x, y) + self.c


@frozen_dataclass
class PolynomialKernel(Kernel):
    """k(x, y) = (⟨x, y⟩ + c)^degree."""

    c: object
    degree: int = static_field(default=2)

    def matrix(self, x, y):
        return (pairwise.pairwise_dot(x, y) + self.c) ** self.degree

    def diag(self, x, y):
        return (pairwise.dot_diag(x, y) + self.c) ** self.degree


@frozen_dataclass
class ExponentiatedKernel(Kernel):
    """k(x, y) = exp(⟨x, y⟩)."""

    def matrix(self, x, y):
        return _exp(pairwise.pairwise_dot(x, y))

    def diag(self, x, y):
        return _exp(pairwise.dot_diag(x, y))


@frozen_dataclass
class WienerKernel(Kernel):
    """Brownian motion, k(x, y) = min(x, y), on scalar inputs ≥ 0."""

    def _vals(self, x):
        return pairwise.ensure_2d(x)[:, 0]

    def matrix(self, x, y):
        return torch.minimum(self._vals(x)[:, None], self._vals(y)[None, :])

    def diag(self, x, y):
        return torch.minimum(self._vals(x), self._vals(y))


@frozen_dataclass
class FBMKernel(Kernel):
    """Fractional Brownian motion with Hurst index h ∈ (0, 1):
    ½ (‖x‖²ʰ + ‖y‖²ʰ − ‖x − y‖²ʰ)."""

    h: object = 0.5

    def _pow(self, sq):
        # |·|^{2h} from the squared quantity, with a zero-safe gradient
        eps = torch.finfo(sq.dtype).eps ** 2
        return torch.where(sq > 0, torch.clamp(sq, min=eps) ** self.h, 0.0)

    def matrix(self, x, y):
        px = self._pow(pairwise.dot_diag(x, x))
        py = self._pow(pairwise.dot_diag(y, y))
        return 0.5 * (px[:, None] + py[None, :] - self._pow(pairwise.pairwise_sqdist(x, y)))

    def diag(self, x, y):
        px = self._pow(pairwise.dot_diag(x, x))
        py = self._pow(pairwise.dot_diag(y, y))
        return 0.5 * (px + py - self._pow(pairwise.sqdist_diag(x, y)))

    def matrix_same(self, x):
        d2 = pairwise.pairwise_sqdist(x, x)
        d2.fill_diagonal_(0.0)  # an exact zero diagonal
        p = self._pow(pairwise.dot_diag(x, x))
        return 0.5 * (p[:, None] + p[None, :] - self._pow(d2))

    def diag_same(self, x):
        return self._pow(pairwise.dot_diag(x, x))


@frozen_dataclass
class NeuralNetworkKernel(Kernel):
    """The arcsine kernel of Williams (1998):
    asin(⟨x, y⟩ / √((1 + ‖x‖²)(1 + ‖y‖²)))."""

    def matrix(self, x, y):
        dot = pairwise.pairwise_dot(x, y)
        nx = 1.0 + pairwise.dot_diag(x, x)
        ny = 1.0 + pairwise.dot_diag(y, y)
        return torch.asin(torch.clamp(dot / torch.sqrt(nx[:, None] * ny[None, :]), -1.0, 1.0))

    def diag(self, x, y):
        dot = pairwise.dot_diag(x, y)
        nx = 1.0 + pairwise.dot_diag(x, x)
        ny = 1.0 + pairwise.dot_diag(y, y)
        return torch.asin(torch.clamp(dot / torch.sqrt(nx * ny), -1.0, 1.0))

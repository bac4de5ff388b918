"""The Neural Kernel Network (counterpart of `stheno_tpu/kernels/nkn.py`; Sun
et al. 2018, "Differentiable Compositional Kernel Learning for Gaussian
Processes"), a differentiable composition of primitive kernels.

P primitive kernels are evaluated pointwise and their values stacked on a
trailing axis, (N, M, P); a small network whose operations keep kernels
positive definite maps that stack to one kernel:

- `LinearLayer`: a combination with nonnegative weights exp(log_w) and an
  optional nonnegative bias exp(log_b) (a constant kernel), the weights
  held in log scale and trained unconstrained;
- `ProductLayer`: products of adjacent groups (a kernel times a kernel is
  a kernel).

Each layer is one small batched matmul or reshape-product over the
trailing axis: (N·M, P) @ (P, P') on `torch.matmul`.  Primitives that are
stationary kernels go through kernel 1; the others are plain PyTorch, as
the reference computes them.  The O(N) diagonal maps the same network over
the (N, P) primitive diagonals.
"""

from __future__ import annotations

import math

import torch

from stheno_tpu_torch.kernels.base import Kernel
from stheno_tpu_torch.tree import frozen_dataclass, static_field

__all__ = ["LinearLayer", "ProductLayer", "NeuralKernelNetwork"]


@frozen_dataclass
class LinearLayer:
    """feats (..., in) → (..., out): feats @ exp(log_w)ᵀ + exp(log_b).
    Nonnegative weights keep every output unit a conic combination of
    kernels; `log_b=None` leaves out the bias."""

    log_w: torch.Tensor  # (out, in)
    log_b: torch.Tensor | None = None  # (out,)

    def __call__(self, feats):
        out = feats @ torch.exp(self.log_w).T
        if self.log_b is not None:
            out = out + torch.exp(self.log_b)
        return out

    @staticmethod
    def init(generator, n_in, n_out, bias=True, dtype=torch.float64):
        """Near-uniform positive weights, log(1/n_in) + 0.1·ε, and a bias
        near e⁻⁴, with ε standard normal from `generator` (a
        `torch.Generator`; the layer lies on its device)."""
        dev = generator.device

        def normal(*shape):
            return torch.randn(shape, generator=generator, dtype=dtype, device=dev)

        log_w = -math.log(float(n_in)) + 0.1 * normal(n_out, n_in)
        log_b = -4.0 + 0.1 * normal(n_out) if bias else None
        return LinearLayer(log_w, log_b)


@frozen_dataclass
class ProductLayer:
    """feats (..., P) → (..., P / stride): products of adjacent groups of
    `stride` units."""

    stride: int = static_field(default=2)

    def __call__(self, feats):
        p = feats.shape[-1]
        if p % self.stride:
            raise ValueError(f"ProductLayer stride {self.stride} does not divide width {p}")
        groups = feats.reshape(*feats.shape[:-1], p // self.stride, self.stride)
        # a chain of products, whose backward needs no division by a unit
        # that underflowed to 0 (as `torch.prod`'s does)
        out = groups[..., 0]
        for i in range(1, self.stride):
            out = out * groups[..., i]
        return out


@frozen_dataclass
class NeuralKernelNetwork(Kernel):
    """k(x, y) = network(k_1(x, y), ..., k_P(x, y)).

    `primitives`: a tuple of kernels; `layers`: a tuple of `LinearLayer` and
    `ProductLayer` (any callable mapping (..., w_i) → (..., w_{i+1})), the
    last of width 1."""

    primitives: tuple
    layers: tuple

    def _apply(self, feats):
        for layer in self.layers:
            feats = layer(feats)
        if feats.shape[-1] != 1:
            raise ValueError(f"NKN layers must end at width 1, got {feats.shape[-1]}")
        return feats[..., 0]

    def matrix(self, x, y):
        return self._apply(torch.stack([k.matrix(x, y) for k in self.primitives], dim=-1))

    def matrix_same(self, x):
        # the primitives' own matrix_same pins stationary diagonals exactly
        return self._apply(torch.stack([k.matrix_same(x) for k in self.primitives], dim=-1))

    def diag(self, x, y):
        return self._apply(torch.stack([k.diag(x, y) for k in self.primitives], dim=-1))

    def diag_same(self, x):
        return self._apply(torch.stack([k.diag_same(x) for k in self.primitives], dim=-1))

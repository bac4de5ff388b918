"""The process graph (counterpart of `stheno_tpu/graph.py`: `GPC`, the
`AbstractProcess` sugar, `AtomicGP`, `GP`, `SumGP`, `ScaledGP` and the
`cross_cov`/`cross_var` recursion).

Every node carries a topological index `n` from its programme's `GPC`
counter.  `cross_cov(f, g, x, x2)` is

- the node's own pairwise rule when f and g are the same node;
- identically zero when an *atomic* node has the larger index (independence
  by construction);
- otherwise distributed into the arguments of the higher-index node.

The zero is structural here: the internal recursion returns None for it and
every sum skips it, so `SumGP.cov` of two independent atomics adds their two
covariances and never materialises (or adds) the two zero cross blocks.  The
public `cross_cov`/`cross_var` return dense zeros, as the reference does.

The affine ops (the reference's `graph.py:130-1012`): constant and function
shifts (`AddConstGP`, `AddFnGP`), function scalings (`ScaledFnGP`), input
warps and composition (`CompositeGP`: `stretch`, `select`, `periodic`,
`shift`, `compose`, `f @ warp`), `additive_gp`, wrapped leaves
(`WrappedGP`, `atomic`) and the stacking of processes over `BlockData`
(`CrossGP`, `cross`), which `GPPP` routing builds for a `BlockData` query;
its dense block assembly is a `cov.cross` span (`utils/logging.py`), credited
with the `blocks` it computes and their `elems`.
A function-valued argument is a `ParamFn` (its tensors reach autograd as
any tensor does), a warp, or any callable (held as a `StaticFn`).

Derivative processes (`DerivativeGP`, `derivative`) take every statistic
as an exact derivative of the parent's by `torch.func.jvp` (nested for
∂ₓ∂_y k), through kernel 1's forward-mode rule; convolved processes
(`ConvolvedGP`, `convolve_quadrature`) contract the parent's statistics
with a quadrature weight matrix, GEMMs on `torch.matmul`.
"""

from __future__ import annotations

import torch

import dataclasses
import math

from stheno_tpu_torch.inputs import BlockData, input_device, input_dtype, input_length
from stheno_tpu_torch.kernels.base import Kernel, kernelmatrix, kernelmatrix_diag
from stheno_tpu_torch.means import MeanFunction, as_mean
from stheno_tpu_torch.ops.pairwise import ensure_2d
from stheno_tpu_torch.tree import as_param, frozen_dataclass, static_field
from stheno_tpu_torch.utils import logging as _trace


class GPC:
    """Mutable counter assigning topological indices to graph nodes.
    Programme membership is object identity (`is`)."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def next_index(self) -> int:
        self.n += 1
        return self.n

    def __eq__(self, other):
        return isinstance(other, GPC)

    def __hash__(self):
        return 0

    def __enter__(self):
        _GPC_STACK.append(self)
        return self

    def __exit__(self, *exc):
        _GPC_STACK.pop()
        return False


_GPC_STACK: list = []


def _current_gpc() -> GPC:
    if not _GPC_STACK:
        raise RuntimeError(
            "GP(...) requires an active GPC. Either pass gpc= explicitly, "
            "build the model inside a @gppp-decorated function, or use "
            "`with GPC() as gpc:`."
        )
    return _GPC_STACK[-1]


def _check_same_gpc(*fs):
    gpc = fs[0].gpc
    for f in fs[1:]:
        if f.gpc is not gpc:
            raise ValueError("Cannot combine GPs from different programmes (GPCs).")
    return gpc


def _sum(*terms):
    """Sum of the terms that are not structural zeros (None if all are)."""
    out = None
    for t in terms:
        if t is not None:
            out = t if out is None else out + t
    return out


def _scale(s, t):
    return None if t is None else s * t


@frozen_dataclass
class StaticFn:
    """A callable held as it is: its tensors, if any, are differentiated
    wherever autograd meets them."""

    fn: object = static_field()

    def __call__(self, x):
        return self.fn(x)


@frozen_dataclass
class ParamFn:
    """`fn(params, x)` with `params` a tree of tensors: a function-valued
    scaling, shift or warp whose parameters reach the gradient.

        sigma = ParamFn(lambda p, x: p["a"] * torch.tanh(x), {"a": theta})
        g = sigma * f
    """

    fn: object = static_field()
    params: object = None

    def __call__(self, x):
        return self.fn(self.params, x)


def as_callable_tree(f):
    """A function-valued op argument as the ops hold it: a dataclass
    callable (a `ParamFn`, `StaticFn` or warp) as it is, any other callable
    as a `StaticFn`."""
    if not callable(f):
        raise TypeError(f"expected a callable, got {type(f)}")
    if dataclasses.is_dataclass(f):
        return f
    return StaticFn(f)


class AbstractProcess:
    """A (prior) Gaussian process node inside a programme.

    Interface: ``mean(x)``, ``cov(x)``, ``cov2(x, x2)``, ``var(x)``,
    ``var2(x, x2)``, plus the distribution rules ``_cross_cov_l/_r`` and
    ``_cross_var_l/_r`` used by the recursion (which return None for a
    structural zero).
    """

    _is_atomic = False

    def __add__(self, other):
        if isinstance(other, AbstractProcess):
            _check_same_gpc(self, other)
            return SumGP(self, other, n=self.gpc.next_index(), gpc=self.gpc)
        if callable(other):
            return AddFnGP(as_callable_tree(other), self, n=self.gpc.next_index(), gpc=self.gpc)
        return AddConstGP(as_param(other), self, n=self.gpc.next_index(), gpc=self.gpc)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        if isinstance(other, AbstractProcess):
            return self + (-other)
        return self + (-as_param(other))

    def __rsub__(self, other):
        return other + (-self)

    def __mul__(self, other):
        if isinstance(other, AbstractProcess):
            raise TypeError("Cannot multiply two GPs together.")
        if callable(other):
            return ScaledFnGP(as_callable_tree(other), self, n=self.gpc.next_index(), gpc=self.gpc)
        return ScaledGP(as_param(other), self, n=self.gpc.next_index(), gpc=self.gpc)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return (-1.0) * self

    def __matmul__(self, warp):
        """`f @ warp`: input composition, f ∘ warp."""
        return compose(self, warp)

    def __call__(self, x, noise=None):
        from stheno_tpu_torch.finite_gp import FiniteGP

        return FiniteGP(self, x, noise)


@frozen_dataclass(eq=False)
class AtomicGP(AbstractProcess):
    """Leaf process: mean function + kernel + topological index.  Distinct
    atomics are independent."""

    mean_fn: MeanFunction
    kernel: Kernel
    n: int = static_field()
    gpc: GPC = static_field()

    _is_atomic = True

    def mean(self, x):
        return self.mean_fn(x)

    def cov(self, x):
        return kernelmatrix(self.kernel, x)

    def cov2(self, x, x2):
        return kernelmatrix(self.kernel, x, x2)

    def var(self, x):
        return kernelmatrix_diag(self.kernel, x)

    def var2(self, x, x2):
        return kernelmatrix_diag(self.kernel, x, x2)


def GP(mean_or_kernel, kernel=None, gpc=None) -> AtomicGP:
    """`GP(kernel)` or `GP(mean, kernel)`: an atomic process of the active
    programme (or of `gpc`)."""
    if kernel is None:
        mean, kern = None, mean_or_kernel
    else:
        mean, kern = mean_or_kernel, kernel
    if not isinstance(kern, Kernel):
        raise TypeError(f"expected a Kernel, got {type(kern)}")
    gpc = gpc if gpc is not None else _current_gpc()
    return AtomicGP(as_mean(mean), kern, n=gpc.next_index(), gpc=gpc)


_STATS_INTERFACE = ("mean", "cov", "cov2", "var", "var2")


@frozen_dataclass(eq=False)
class WrappedGP(AbstractProcess):
    """Leaf node wrapping any object with the statistics interface (a GPPP,
    a `PosteriorGP`, a process of another programme) as an independent
    atomic of this programme: it keeps its own structure, and its cross
    covariance with any other leaf is zero."""

    wrapped: object
    n: int = static_field()
    gpc: GPC = static_field()

    _is_atomic = True

    def mean(self, x):
        return self.wrapped.mean(x)

    def cov(self, x):
        return self.wrapped.cov(x)

    def cov2(self, x, x2):
        return self.wrapped.cov2(x, x2)

    def var(self, x):
        return self.wrapped.var(x)

    def var2(self, x, x2):
        return self.wrapped.var2(x, x2)


def atomic(gp, gpc=None) -> AbstractProcess:
    """Register `gp` in the programme `gpc` (or the active one) as a fresh
    leaf: an `AtomicGP` takes a new index, a `(mean, kernel)` pair becomes
    one, and any object with mean/cov/cov2/var/var2 is wrapped as a
    `WrappedGP`."""
    gpc = gpc if gpc is not None else _current_gpc()
    if isinstance(gp, AtomicGP):
        return AtomicGP(gp.mean_fn, gp.kernel, n=gpc.next_index(), gpc=gpc)
    if isinstance(gp, tuple) and len(gp) == 2:
        return AtomicGP(as_mean(gp[0]), gp[1], n=gpc.next_index(), gpc=gpc)
    if all(hasattr(gp, m) for m in _STATS_INTERFACE):
        return WrappedGP(gp, n=gpc.next_index(), gpc=gpc)
    raise TypeError(
        "atomic expects an AtomicGP, a (mean, kernel) tuple, or any object "
        "implementing mean/cov/cov2/var/var2 (GPPP, PosteriorGP, ...)"
    )


@frozen_dataclass(eq=False)
class SumGP(AbstractProcess):
    left: AbstractProcess
    right: AbstractProcess
    n: int = static_field()
    gpc: GPC = static_field()

    def mean(self, x):
        return self.left.mean(x) + self.right.mean(x)

    def cov(self, x):
        return _sum(
            self.left.cov(x),
            self.right.cov(x),
            _cross_cov(self.left, self.right, x, x),
            _cross_cov(self.right, self.left, x, x),
        )

    def cov2(self, x, x2):
        return _sum(
            self.left.cov2(x, x2),
            self.right.cov2(x, x2),
            _cross_cov(self.left, self.right, x, x2),
            _cross_cov(self.right, self.left, x, x2),
        )

    def var(self, x):
        return _sum(
            self.left.var(x),
            self.right.var(x),
            _cross_var(self.left, self.right, x, x),
            _cross_var(self.right, self.left, x, x),
        )

    def var2(self, x, x2):
        return _sum(
            self.left.var2(x, x2),
            self.right.var2(x, x2),
            _cross_var(self.left, self.right, x, x2),
            _cross_var(self.right, self.left, x, x2),
        )

    def _cross_cov_l(self, other, x, x2):
        return _sum(_cross_cov(self.left, other, x, x2), _cross_cov(self.right, other, x, x2))

    def _cross_cov_r(self, other, x, x2):
        return _sum(_cross_cov(other, self.left, x, x2), _cross_cov(other, self.right, x, x2))

    def _cross_var_l(self, other, x, x2):
        return _sum(_cross_var(self.left, other, x, x2), _cross_var(self.right, other, x, x2))

    def _cross_var_r(self, other, x, x2):
        return _sum(_cross_var(other, self.left, x, x2), _cross_var(other, self.right, x, x2))


class _PassthroughCov(AbstractProcess):
    """The covariance rules of an op that only shifts the mean."""

    def cov(self, x):
        return self.f.cov(x)

    def cov2(self, x, x2):
        return self.f.cov2(x, x2)

    def var(self, x):
        return self.f.var(x)

    def var2(self, x, x2):
        return self.f.var2(x, x2)

    def _cross_cov_l(self, other, x, x2):
        return _cross_cov(self.f, other, x, x2)

    def _cross_cov_r(self, other, x, x2):
        return _cross_cov(other, self.f, x, x2)

    def _cross_var_l(self, other, x, x2):
        return _cross_var(self.f, other, x, x2)

    def _cross_var_r(self, other, x, x2):
        return _cross_var(other, self.f, x, x2)


@frozen_dataclass(eq=False)
class AddConstGP(_PassthroughCov):
    """`b + f` for a constant b: shifts the mean."""

    b: object  # a tensor or a float (`as_param`)
    f: AbstractProcess
    n: int = static_field()
    gpc: GPC = static_field()

    def mean(self, x):
        return self.b + self.f.mean(x)


@frozen_dataclass(eq=False)
class AddFnGP(_PassthroughCov):
    """`b + f` for a deterministic function b mapping (N,[D]) → (N,)."""

    b: object
    f: AbstractProcess
    n: int = static_field()
    gpc: GPC = static_field()

    def mean(self, x):
        return torch.as_tensor(self.b(torch.as_tensor(x))) + self.f.mean(x)


@frozen_dataclass(eq=False)
class ScaledGP(AbstractProcess):
    """`σ * f` for a constant σ."""

    sigma: object  # a tensor or a float (`as_param`)
    f: AbstractProcess
    n: int = static_field()
    gpc: GPC = static_field()

    def mean(self, x):
        return self.sigma * self.f.mean(x)

    def cov(self, x):
        return (self.sigma**2) * self.f.cov(x)

    def cov2(self, x, x2):
        return (self.sigma**2) * self.f.cov2(x, x2)

    def var(self, x):
        return (self.sigma**2) * self.f.var(x)

    def var2(self, x, x2):
        return (self.sigma**2) * self.f.var2(x, x2)

    def _cross_cov_l(self, other, x, x2):
        return _scale(self.sigma, _cross_cov(self.f, other, x, x2))

    def _cross_cov_r(self, other, x, x2):
        return _scale(self.sigma, _cross_cov(other, self.f, x, x2))

    def _cross_var_l(self, other, x, x2):
        return _scale(self.sigma, _cross_var(self.f, other, x, x2))

    def _cross_var_r(self, other, x, x2):
        return _scale(self.sigma, _cross_var(other, self.f, x, x2))


def _scale_rows(s, t):
    return None if t is None else s[:, None] * t


def _scale_cols(t, s):
    return None if t is None else t * s[None, :]


@frozen_dataclass(eq=False)
class ScaledFnGP(AbstractProcess):
    """`σ * f` for a deterministic function σ mapping (N,[D]) → (N,)."""

    sigma: object
    f: AbstractProcess
    n: int = static_field()
    gpc: GPC = static_field()

    def _s(self, x):
        return torch.as_tensor(self.sigma(torch.as_tensor(x)))

    def mean(self, x):
        return self._s(x) * self.f.mean(x)

    def cov(self, x):
        s = self._s(x)
        return s[:, None] * self.f.cov(x) * s[None, :]

    def cov2(self, x, x2):
        return self._s(x)[:, None] * self.f.cov2(x, x2) * self._s(x2)[None, :]

    def var(self, x):
        return self._s(x) ** 2 * self.f.var(x)

    def var2(self, x, x2):
        return self._s(x) * self.f.var2(x, x2) * self._s(x2)

    def _cross_cov_l(self, other, x, x2):
        return _scale_rows(self._s(x), _cross_cov(self.f, other, x, x2))

    def _cross_cov_r(self, other, x, x2):
        return _scale_cols(_cross_cov(other, self.f, x, x2), self._s(x2))

    def _cross_var_l(self, other, x, x2):
        return _scale(self._s(x), _cross_var(self.f, other, x, x2))

    def _cross_var_r(self, other, x, x2):
        return _scale(self._s(x2), _cross_var(other, self.f, x, x2))


# ---------------------------------------------------------------------------
# Input warps and composition (reference `graph.py:589-729`)
# ---------------------------------------------------------------------------


@frozen_dataclass
class Stretch:
    """x ↦ l·x for a scalar, per-dimension vector or matrix l."""

    l: object  # noqa: E741 - the reference's name

    def __call__(self, x):
        x = torch.as_tensor(x)
        l = self.l  # noqa: E741
        if torch.is_tensor(l) and l.dim() == 2:
            return ensure_2d(x) @ l.T
        if torch.is_tensor(l) and l.dim() == 1 and x.dim() == 2:
            return x * l[None, :]
        return l * x


@frozen_dataclass
class Select:
    """x ↦ x[:, idx]; an integer idx gives one scalar per point."""

    idx: object = static_field()

    def __call__(self, x):
        x = ensure_2d(x)
        if isinstance(self.idx, int):
            return x[:, self.idx]
        return x[:, torch.as_tensor(self.idx, device=x.device)]


@frozen_dataclass
class Periodic:
    """t ↦ [cos(2π f t), sin(2π f t)], a 2-D embedding of scalar inputs."""

    freq: object

    def __call__(self, x):
        x = torch.as_tensor(x)
        if x.dim() == 2 and x.shape[1] == 1:
            x = x[:, 0]
        w = 2.0 * math.pi * self.freq
        return torch.stack([torch.cos(w * x), torch.sin(w * x)], dim=-1)


@frozen_dataclass
class Shift:
    """x ↦ x − a."""

    a: object

    def __call__(self, x):
        x = torch.as_tensor(x)
        a = self.a
        if x.dim() == 2 and torch.is_tensor(a) and a.dim() == 1:
            return x - a[None, :]
        return x - a


@frozen_dataclass
class FnWarp:
    """Any vectorised input map (N,[D]) → (N,[D']); wrap a parameterised
    one in `ParamFn`."""

    fn: object = None

    def __call__(self, x):
        return self.fn(torch.as_tensor(x))


_WARPS = (Stretch, Select, Periodic, Shift, FnWarp)


@frozen_dataclass(eq=False)
class CompositeGP(AbstractProcess):
    """f ∘ warp: the statistics of f at warped inputs."""

    f: AbstractProcess
    warp: object
    n: int = static_field()
    gpc: GPC = static_field()

    def mean(self, x):
        return self.f.mean(self.warp(x))

    def cov(self, x):
        return self.f.cov(self.warp(x))

    def cov2(self, x, x2):
        return self.f.cov2(self.warp(x), self.warp(x2))

    def var(self, x):
        return self.f.var(self.warp(x))

    def var2(self, x, x2):
        return self.f.var2(self.warp(x), self.warp(x2))

    def _cross_cov_l(self, other, x, x2):
        return _cross_cov(self.f, other, self.warp(x), x2)

    def _cross_cov_r(self, other, x, x2):
        return _cross_cov(other, self.f, x, self.warp(x2))

    def _cross_var_l(self, other, x, x2):
        return _cross_var(self.f, other, self.warp(x), x2)

    def _cross_var_r(self, other, x, x2):
        return _cross_var(other, self.f, x, self.warp(x2))


def compose(f: AbstractProcess, warp) -> CompositeGP:
    """f ∘ warp; a plain callable becomes an `FnWarp`."""
    if not isinstance(warp, _WARPS) and callable(warp):
        warp = FnWarp(as_callable_tree(warp))
    return CompositeGP(f, warp, n=f.gpc.next_index(), gpc=f.gpc)


def stretch(f: AbstractProcess, l) -> CompositeGP:  # noqa: E741
    """`stretch(f, l)(x) == f(l·x)`: lengthscale 1/l."""
    return compose(f, Stretch(as_param(l)))


def select(f: AbstractProcess, idx) -> CompositeGP:
    """f of the input dimensions `idx`."""
    return compose(f, Select(idx))


def periodic(f: AbstractProcess, freq) -> CompositeGP:
    """A periodic process of frequency `freq`, by the 2-D embedding."""
    return compose(f, Periodic(as_param(freq)))


def shift(f: AbstractProcess, a) -> CompositeGP:
    """`shift(f, a)(x) == f(x − a)`."""
    return compose(f, Shift(as_param(a)))


def additive_gp(fs, indices=None) -> AbstractProcess:
    """Σ_d f_d(x[:, indices_d]): an additive process across input
    dimensions."""
    fs = list(fs)
    if indices is None:
        indices = list(range(len(fs)))
    if len(fs) != len(indices):
        raise ValueError("length(fs) must equal length(indices)")
    out = None
    for f, idx in zip(fs, indices):
        p = select(f, idx)
        out = p if out is None else out + p
    return out


# ---------------------------------------------------------------------------
# Derivative processes (reference `graph.py:745-823`): exact, by forward mode
# ---------------------------------------------------------------------------


def _jvp_ones(fn, x):
    """The tangent of `fn` at x along unit tangents, one jvp: a per-point
    derivative, since every statistic's dependence on the i-th input point
    is confined to its row (entry) i.  None where `fn` returns None (a
    structural zero stays one)."""
    zero = []

    def g(xx):
        out = fn(xx)
        if out is None:
            zero.append(True)
            return xx.new_zeros(())
        return out

    x = torch.as_tensor(x)
    tangent = torch.func.jvp(g, (x,), (torch.ones_like(x),))[1]
    return None if zero else tangent


@frozen_dataclass(eq=False)
class DerivativeGP(AbstractProcess):
    """f′, the derivative process of a once-differentiable process of 1-D
    inputs.  Its statistics are exact derivatives of the parent's:
    mean′(x) = ∂ₓ mean(x), cov(f′, f′)(x, y) = ∂ₓ∂_y k(x, y) and
    cov(f′, g)(x, y) = ∂ₓ k_fg(x, y), by (nested) `torch.func.jvp`, so they
    compose with every kernel, warp and op of the graph and with
    conditioning (observe f, predict f′, and the reverse)."""

    f: AbstractProcess
    n: int = static_field()
    gpc: GPC = static_field()

    def mean(self, x):
        return _jvp_ones(self.f.mean, x)

    def cov(self, x):
        return self.cov2(x, x)

    def cov2(self, x, x2):
        return _jvp_ones(lambda xx: _jvp_ones(lambda yy: self.f.cov2(xx, yy), x2), x)

    def var(self, x):
        return self.var2(x, x)

    def var2(self, x, x2):
        return _jvp_ones(lambda xx: _jvp_ones(lambda yy: self.f.var2(xx, yy), x2), x)

    def _cross_cov_l(self, other, x, x2):
        return _jvp_ones(lambda xx: _cross_cov(self.f, other, xx, x2), x)

    def _cross_cov_r(self, other, x, x2):
        return _jvp_ones(lambda yy: _cross_cov(other, self.f, x, yy), x2)

    def _cross_var_l(self, other, x, x2):
        return _jvp_ones(lambda xx: _cross_var(self.f, other, xx, x2), x)

    def _cross_var_r(self, other, x, x2):
        return _jvp_ones(lambda yy: _cross_var(other, self.f, x, yy), x2)


def derivative(f: AbstractProcess) -> DerivativeGP:
    """The derivative process f′ (1-D inputs).  Composes freely: sums,
    scalings, warps, second derivatives (`derivative(derivative(f))`),
    conditioning across f and f′."""
    return DerivativeGP(f, n=f.gpc.next_index(), gpc=f.gpc)


# ---------------------------------------------------------------------------
# Quadrature convolution (reference `graph.py:825-907`)
# ---------------------------------------------------------------------------


@frozen_dataclass(eq=False)
class ConvolvedGP(AbstractProcess):
    """(Cf)(x) ≈ Σ_j w(x, τ_j) Δ_j f(τ_j) over fixed quadrature nodes τ: a
    linear functional of f, so every statistic is a contraction of the
    parent's with W = w(x, τ)·diag(Δ).

    `weight_fn(x, tau) -> (N, Q)` evaluates the window between each output
    point and each node (on tensors); `nodes` are the quadrature points
    (Q,) or (Q, D), `deltas` the quadrature weights (Q,)."""

    f: AbstractProcess
    nodes: torch.Tensor
    deltas: torch.Tensor
    weight_fn: object = static_field()
    n: int = static_field()
    gpc: GPC = static_field()

    def _w(self, x):
        W = torch.as_tensor(self.weight_fn(torch.as_tensor(x), self.nodes))
        return W * self.deltas[None, :]

    def mean(self, x):
        return self._w(x) @ self.f.mean(self.nodes)

    def cov(self, x):
        W = self._w(x)
        return W @ self.f.cov(self.nodes) @ W.T

    def cov2(self, x, x2):
        return self._w(x) @ self.f.cov(self.nodes) @ self._w(x2).T

    def var(self, x):
        W = self._w(x)
        return torch.sum((W @ self.f.cov(self.nodes)) * W, dim=1)

    def var2(self, x, x2):
        return torch.sum((self._w(x) @ self.f.cov(self.nodes)) * self._w(x2), dim=1)

    def _cross_cov_l(self, other, x, x2):
        c = _cross_cov(self.f, other, self.nodes, x2)
        return None if c is None else self._w(x) @ c

    def _cross_cov_r(self, other, x, x2):
        c = _cross_cov(other, self.f, x, self.nodes)
        return None if c is None else c @ self._w(x2).T

    def _cross_var_l(self, other, x, x2):
        c = _cross_cov(self.f, other, self.nodes, x2)
        return None if c is None else torch.sum(self._w(x) * c.T, dim=1)

    def _cross_var_r(self, other, x, x2):
        c = _cross_cov(other, self.f, x, self.nodes)
        return None if c is None else torch.sum(c * self._w(x2), dim=1)


def convolve_quadrature(f: AbstractProcess, weight_fn, nodes, deltas=None) -> ConvolvedGP:
    """Convolve `f` with the window `weight_fn` on quadrature `nodes`.

    `deltas` defaults to the trapezoid weights of a uniform 1-D grid.  The
    result conditions jointly with f and every derived process
    (deconvolution: observe Cf, predict f)."""
    nodes = torch.as_tensor(nodes)
    if deltas is None:
        if nodes.dim() != 1:
            raise ValueError("provide explicit deltas for non-1D nodes")
        dx = nodes[1] - nodes[0]
        deltas = torch.full_like(nodes, 1.0) * dx
        deltas = torch.cat([0.5 * deltas[:1], deltas[1:-1], 0.5 * deltas[-1:]])
    return ConvolvedGP(f, nodes, torch.as_tensor(deltas), weight_fn, n=f.gpc.next_index(),
                       gpc=f.gpc)


# ---------------------------------------------------------------------------
# Cross: processes stacked over BlockData (reference `graph.py:908-1012`)
# ---------------------------------------------------------------------------


@frozen_dataclass(eq=False)
class CrossGP(AbstractProcess):
    """One process over `BlockData`, formed by stacking `fs`: block i of
    the inputs goes to process i."""

    fs: tuple
    n: int = static_field()
    gpc: GPC = static_field()

    def _blocks(self, x):
        if not isinstance(x, BlockData):
            raise TypeError("CrossGP expects BlockData inputs")
        if len(x.blocks) != len(self.fs):
            raise ValueError(
                f"BlockData has {len(x.blocks)} blocks but cross has {len(self.fs)} processes"
            )
        return x.blocks

    def mean(self, x):
        return torch.cat([f.mean(b) for f, b in zip(self.fs, self._blocks(x))])

    def cov(self, x):
        return self.cov2(x, x)

    def cov2(self, x, x2):
        bs = self._blocks(x)
        if not isinstance(x2, BlockData):
            raise TypeError("CrossGP.cov2 expects BlockData on both sides")
        bs2 = self._blocks(x2)
        with _trace.span("cov.cross") as sp:
            rows = [torch.cat([cross_cov(fi, fj, bi, bj) for fj, bj in zip(self.fs, bs2)], dim=1)
                    for fi, bi in zip(self.fs, bs)]
            K = torch.cat(rows, dim=0)
            if sp is not None:
                _trace.credit("blocks", len(bs) * len(bs2))
                _trace.credit("elems", K.numel())
        return K

    def var(self, x):
        return torch.cat([f.var(b) for f, b in zip(self.fs, self._blocks(x))])

    def var2(self, x, x2):
        return torch.cat([f.var2(b, b2) for f, b, b2 in
                          zip(self.fs, self._blocks(x), self._blocks(x2))])

    # the blocks are concatenated dense (a structural zero block becomes
    # zeros), as the reference's are
    def _cross_cov_l(self, other, x, x2):
        return torch.cat([cross_cov(f, other, b, x2) for f, b in zip(self.fs, self._blocks(x))])

    def _cross_cov_r(self, other, x, x2):
        return torch.cat([cross_cov(other, f, x, b) for f, b in zip(self.fs, self._blocks(x2))],
                         dim=1)

    def _cross_var_l(self, other, x, x2):
        # the paired diagonal slices the flat x2 to match each block (O(N));
        # against another BlockData it is the diagonal of the dense block
        if isinstance(x2, BlockData):
            return torch.diagonal(self._cross_cov_l(other, x, x2))
        out, off = [], 0
        for f, b in zip(self.fs, self._blocks(x)):
            nb = input_length(b)
            out.append(cross_var(f, other, b, x2[off: off + nb]))
            off += nb
        return torch.cat(out)

    def _cross_var_r(self, other, x, x2):
        if isinstance(x, BlockData):
            return torch.diagonal(self._cross_cov_r(other, x, x2))
        out, off = [], 0
        for f, b2 in zip(self.fs, self._blocks(x2)):
            nb = input_length(b2)
            out.append(cross_var(other, f, x[off: off + nb], b2))
            off += nb
        return torch.cat(out)


def cross(fs) -> CrossGP:
    """Stack processes of one programme into one process over `BlockData`
    (used by `GPPP` routing)."""
    fs = tuple(fs)
    if len(fs) < 1:
        raise ValueError("cross requires at least one process")
    gpc = _check_same_gpc(*fs)
    return CrossGP(fs, n=gpc.next_index(), gpc=gpc)


# ---------------------------------------------------------------------------
# Constant leaves taken out of a covariance


def _children(f):
    """The processes node `f` is built from."""
    for fld in dataclasses.fields(f):
        v = getattr(f, fld.name)
        if isinstance(v, AbstractProcess):
            yield v
        elif isinstance(v, tuple):
            yield from (c for c in v if isinstance(c, AbstractProcess))


def _leaf_uses(f, uses):
    """Add to `uses` (by leaf index) every path from `f` down to each leaf."""
    if f._is_atomic:
        uses[f.n] = uses.get(f.n, 0) + 1
    for c in _children(f):
        _leaf_uses(c, uses)


def _without_constants(f, uses):
    """(f less its constant leaves, their amplitudes).  A leaf
    `GP(ConstantKernel(c))` reached once (`uses`), through sums and
    scalings alone, adds (σ₁⋯σₖ·√c)²·11ᵀ to f's covariance, σ₁…σₖ the
    scalings above it, and nothing to any cross-covariance; every other
    node is kept whole.  The rest is None where nothing is left."""
    from stheno_tpu_torch.kernels.zoo import ConstantKernel

    if isinstance(f, AtomicGP):
        if isinstance(f.kernel, ConstantKernel) and uses[f.n] == 1:
            c = f.kernel.c
            return None, [torch.sqrt(c) if torch.is_tensor(c) else math.sqrt(c)]
        return f, []
    if isinstance(f, ScaledGP):
        rest, amps = _without_constants(f.f, uses)
        if not amps:
            return f, []
        return (None if rest is None else dataclasses.replace(f, f=rest)), [f.sigma * a for a in amps]
    if isinstance(f, SumGP):
        left, amps_l = _without_constants(f.left, uses)
        right, amps_r = _without_constants(f.right, uses)
        if not (amps_l or amps_r):
            return f, []
        rest = right if left is None else left if right is None else (
            dataclasses.replace(f, left=left, right=right))
        return rest, amps_l + amps_r
    return f, []


def split_constants(f, x):
    """cov(f(x)) as a dense part and a part of rank r: (f′, U, a) with

        cov(f(x)) = cov(f′(x)) + U diag(a²) Uᵀ,

    U (N × r) holding for each constant leaf taken out (`_without_constants`)
    a column of ones on the rows of its block of x (of a `CrossGP` over
    `BlockData`; on every row otherwise) and a (r,) their amplitudes.  A
    block whose process is constant throughout is kept whole.  None where
    no leaf comes out."""
    cross_ = isinstance(f, CrossGP)
    fs, blocks = (f.fs, f._blocks(x)) if cross_ else ((f,), (x,))
    uses = {}
    for g in fs:
        _leaf_uses(g, uses)
    rests, spans, amps, off = [], [], [], 0
    for g, b in zip(fs, blocks):
        rest, a = _without_constants(g, uses)
        if rest is None:
            rest, a = g, []
        rests.append(rest)
        spans += [(off, input_length(b))] * len(a)
        amps += a
        off += input_length(b)
    if not amps:
        return None
    dt, dev = input_dtype(x), input_device(x)
    U = torch.zeros((off, len(amps)), dtype=dt, device=dev)
    for k, (start, nb) in enumerate(spans):
        U[start:start + nb, k] = 1.0
    a = torch.stack([torch.as_tensor(v, dtype=dt).to(dev).reshape(()) for v in amps])
    return (dataclasses.replace(f, fs=tuple(rests)) if cross_ else rests[0]), U, a


def _independent(f, g) -> bool:
    return (f._is_atomic and f.n > g.n) or (g._is_atomic and g.n > f.n)


def _cross_cov(f, g, x, x2):
    """cov(f(x), g(x2)), or None where it is identically zero."""
    if f.gpc is not g.gpc:
        raise ValueError("cross_cov requires processes from the same programme")
    if f.n == g.n:
        return f.cov2(x, x2)
    if _independent(f, g):
        return None
    if f.n >= g.n:
        return f._cross_cov_l(g, x, x2)
    return g._cross_cov_r(f, x, x2)


def _cross_var(f, g, x, x2):
    """Paired diagonal of `_cross_cov`, or None where it is zero."""
    if f.gpc is not g.gpc:
        raise ValueError("cross_var requires processes from the same programme")
    if f.n == g.n:
        return f.var2(x, x2)
    if _independent(f, g):
        return None
    if f.n >= g.n:
        return f._cross_var_l(g, x, x2)
    return g._cross_var_r(f, x, x2)


def cross_cov(f: AbstractProcess, g: AbstractProcess, x, x2):
    """cov(f(x), g(x2)) between any two processes of one programme."""
    out = _cross_cov(f, g, x, x2)
    if out is None:
        out = torch.zeros((input_length(x), input_length(x2)),
                          dtype=input_dtype(x, x2), device=input_device(x, x2))
    return out


def cross_var(f: AbstractProcess, g: AbstractProcess, x, x2):
    """Paired diagonal of cross_cov — O(N), never materialises the matrix."""
    out = _cross_var(f, g, x, x2)
    if out is None:
        out = torch.zeros((input_length(x),), dtype=input_dtype(x, x2),
                          device=input_device(x, x2))
    return out

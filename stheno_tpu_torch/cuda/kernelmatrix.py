"""Kernel 1: the pairwise stationary kernel matrix K[i, j] = σ²·g(‖x_i − y_j‖²).

Replaces the Pallas kernel `stheno_tpu/experimental/pallas/kernelmatrix.py`
(`pairwise_kernelmatrix`) with the CUDA kernel `csrc/kernelmatrix.cu`.
What bounds it on an H100 is the single N×M write of K (1 GiB at
N = M = 16384 in f32, ≈0.32 ms at 3.35 TB/s); the kernel is compiled for
each D from 1 to 16, stages the tile's coordinates in shared memory once,
computes every element in registers and writes 16 bytes a store.  See the
source for the design.

`kernelmatrix(x, y, kind, variance)` is differentiable in `x`, `y` and
`variance` through `_KernelMatrix`: its forward is the kernel on a CUDA
tensor and `kernelmatrix_plain` on a CPU tensor.  Its reverse rule on a
CUDA tensor is the VJP kernel of the same source (`_launch_vjp`), which
reads the cotangent K̄ once, through its own strides, and adds up the
partial sums of its CTAs in a fixed order, so that two calls give the same
bits; it runs through `_KernelMatrixVJPCard`, whose outputs raise if they
are differentiated again.  On a CPU tensor the reverse rule is
`kernelmatrix_vjp`, plain PyTorch in row chunks, differentiable again.  The
caller folds the lengthscale into `x` and `y` (`x / ℓ`), so ∂ℓ flows
through autograd, as at `kernelmatrix.py:95-97` of the reference.  VJP
launches are counted in `VJP_LAUNCHES` by (C, N, M, D, same), C = 1 for
one matrix.  The reverse rule runs in a `cov.reverse` span
(`utils/logging.py`), a child of the span the forward ran in.

Its forward-mode rule (`jvp`, `kernelmatrix_jvp`) is plain PyTorch in row
chunks: K̇ = σ²·g'(sq)·2Σ_k (x_ik − y_jk)(ẋ_ik − ẏ_jk) + σ̇²·g(sq), with
the primal from the kernel.  It runs through `func_transforms.lowered_jvp`,
so an enclosing jvp or reverse pass differentiates the tangent again: the
derivative processes of `graph.py` take ∂ₓ∂_y k by a nested
`torch.func.jvp`, and the logpdf's gradient runs back through both.  The
Matern kernels' g' is 0 wherever the distance is clamped (sq ≤ eps²), as
their VJP's is.

`_KernelMatrix` composes with `torch.func`: under `torch.func.vmap` (a
per-chain lengthscale puts a batch dimension on x, a per-chain variance on
σ²) its `vmap` rule moves the batch dimensions to the front, expands the
unbatched operands as views, and makes one batched launch of the kernel
(`kernelmatrix_batched_forward`: x (C, N, D), y (C, M, D) or None, σ² (C,)),
the counterpart of the batching rule that `jax.vmap` applies to the
`pallas_call`.  The backward under `vmap` goes through `_KernelMatrixVJP`,
whose `vmap` rule runs the batched VJP (one launch of the VJP kernel on the
card); when ordinary autograd differentiates the vmapped call instead (a
`backward()` through the convolutional GP's `var2`), the batched launch's
own Function, `_KernelMatrixBatched`, records the same batched VJP.
Batched launches are counted in `BATCHED_LAUNCHES` by (C, N, M, D, same).

`km_se_d1(x, variance)` replaces the fourth Pallas kernel of the JAX
package, `make_km_pallas` in `scripts/perf_probe.py:116-154`: the same-input
SE matrix of a vector, σ²·exp(−½(x_i − x_j)²).  That is this kernel's
`<float, SE, D = 1>` instance, so the wrapper launches it and counts its
own launches; its plain version is the broadcast formula.  The TPU kernel's
tilings ((256, 2048) and (512, 1024), sized for VMEM) have no meaning on
the card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from stheno_tpu_torch.cuda import _build
from stheno_tpu_torch.func_transforms import lowered_jvp, under_transform
from stheno_tpu_torch.utils import logging as _trace

KINDS = {"se": 0, "matern12": 1, "matern32": 2, "matern52": 3}

#: Launches of the CUDA kernel, by (n, m, d, same).
LAUNCHES = _build.LaunchCounter("kernelmatrix")
#: Batched launches (one for a whole `torch.func.vmap` batch), by
#: (c, n, m, d, same).
BATCHED_LAUNCHES = _build.LaunchCounter("kernelmatrix_batched")
#: Launches made through `km_se_d1`, by (n, n, 1, True).
KM_SE_D1_LAUNCHES = _build.LaunchCounter("km_se_d1")
#: Launches of the VJP kernel, one a reverse pass on the card, by
#: (c, n, m, d, same) with c = 1 for one matrix.
VJP_LAUNCHES = _build.LaunchCounter("kernelmatrix_vjp")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C entry points' argument types, bound once when the library loads
_SIGNATURES = {
    **{f"stheno_kernelmatrix_{t}": [_P] * 4 + [_I] * 5 + [_P] for t in ("f32", "f64")},
    **{f"stheno_kernelmatrix_batched_{t}": [_P] * 4 + [_I] * 6 + [_L] * 3 + [_P]
       for t in ("f32", "f64")},
    **{f"stheno_kernelmatrix_vjp_{t}": [_P] * 7 + [_I] * 6 + [_L] * 6 + [_P] for t in ("f32", "f64")},
    "stheno_kernelmatrix_vjp_plan": [_I] * 5 + [ctypes.POINTER(_L)],
}
_bound_lib = None


def _lib():
    """The kernel library, built at first use, its entry points typed."""
    global _bound_lib
    if _bound_lib is None:
        lib = _build.library("kernelmatrix")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _bound_lib = lib
    return _bound_lib

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def _eps2(dtype):
    return torch.finfo(dtype).eps ** 2


def _dist(sq):
    """‖·‖ from ‖·‖² with the masked-sqrt convention (`zoo.py:35-38`)."""
    return torch.sqrt(torch.clamp(sq, min=_eps2(sq.dtype))) * (sq > 0)


def epilogue(kind: str, sq):
    """g(sq) for the stationary kernel `kind` (elementwise, unit variance)."""
    if kind == "se":
        return torch.exp(-0.5 * sq)
    d = _dist(sq)
    if kind == "matern12":
        return torch.exp(-d)
    if kind == "matern32":
        d3 = _SQRT3 * d
        return (1.0 + d3) * torch.exp(-d3)
    if kind == "matern52":
        d5 = _SQRT5 * d
        return (1.0 + d5 + d5 * d5 / 3.0) * torch.exp(-d5)
    raise ValueError(f"unknown stationary kernel {kind!r}")


def _epilogue_grad(kind: str, sq):
    """(g, dg/dsq) with the masked-sqrt convention: for the Matern kernels
    the derivative is 0 wherever the distance is clamped (sq ≤ eps²), which
    covers the pinned diagonal."""
    g = epilogue(kind, sq)
    if kind == "se":
        return g, -0.5 * g
    live = sq > _eps2(sq.dtype)
    d = torch.sqrt(torch.where(live, sq, torch.ones_like(sq)))
    if kind == "matern12":
        dg = -0.5 * torch.exp(-d) / d
    elif kind == "matern32":
        dg = -1.5 * torch.exp(-_SQRT3 * d)
    else:
        d5 = _SQRT5 * d
        dg = -(5.0 / 6.0) * (1.0 + d5) * torch.exp(-d5)
    return g, dg * live


def _sqdist(x, y):
    """Σ_d (x_id − y_jd)², the direct difference the kernel computes, over
    any leading batch dimensions of x (..., N, D) and y (..., M, D)."""
    sq = None
    for k in range(x.shape[-1]):
        diff = x[..., :, k, None] - y[..., None, :, k]
        sq = diff * diff if sq is None else sq + diff * diff
    return sq


def _per_matrix(variance):
    """σ² shaped to scale a (..., N, M) stack: a batch (C,) of variances
    becomes (C, 1, 1); a 0-d tensor or a number stays as it is."""
    if torch.is_tensor(variance) and variance.dim() > 0:
        return variance[..., None, None]
    return variance


def kernelmatrix_plain(x, y, kind: str, variance):
    """Plain PyTorch version of the kernel (same arithmetic), for x (N, D)
    and y (M, D), or over a leading batch: x (C, N, D), y (C, M, D) and σ²
    (C,).  `y=None` is the same-input call, whose diagonal is exactly
    σ²·g(0) = σ²."""
    sq = _sqdist(x, x if y is None else y)
    if y is None:
        sq.diagonal(dim1=-2, dim2=-1).zero_()
    return _per_matrix(variance) * epilogue(kind, sq)


def _launch(x, y, kind: str, variance, counter=LAUNCHES):
    same = y is None
    yy = x if same else y
    for name, t in (("x", x), ("y", yy)):
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"kernelmatrix: {name} must be a contiguous (N, D) tensor")
    if yy.shape[1] != x.shape[1]:
        raise ValueError(f"kernelmatrix: D differs ({x.shape[1]} vs {yy.shape[1]})")
    if x.dtype not in (torch.float32, torch.float64) or yy.dtype != x.dtype:
        raise TypeError(f"kernelmatrix: needs float32 or float64 inputs, got {x.dtype}/{yy.dtype}")
    if yy.device != x.device or variance.device != x.device:
        raise ValueError("kernelmatrix: inputs and variance must be on one CUDA device")
    var = variance.detach().to(x.dtype).reshape(1).contiguous()
    n, d = x.shape
    m = yy.shape[0]
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    lib = _lib()
    fn = lib.stheno_kernelmatrix_f32 if x.dtype == torch.float32 else lib.stheno_kernelmatrix_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), yy.data_ptr(), var.data_ptr(), out.data_ptr(),
                  n, m, d, KINDS[kind], int(same), stream)
    _build.check(lib, code, "kernelmatrix launch")
    counter.add((n, m, d, same))
    return out


def kernelmatrix_forward(x, y, kind: str, variance):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if kind not in KINDS:
        raise ValueError(f"unknown stationary kernel {kind!r}")
    if x.is_cuda:
        return _launch(x, y, kind, variance)
    return kernelmatrix_plain(x, y, kind, variance)


def _launch_batched(x, y, kind: str, variance):
    """One launch for a batch: x (C, N, D), y (C, M, D) or None, σ² (C,).
    Each (N, D) matrix must be contiguous; the batch stride may be anything,
    0 included (an operand shared by the batch, expanded as a view)."""
    same = y is None
    yy = x if same else y
    for name, t in (("x", x), ("y", yy)):
        if t.dim() != 3 or not t[0].is_contiguous():
            raise ValueError(f"kernelmatrix: batched {name} must be (C, N, D) with contiguous (N, D) slices")
    c, n, d = x.shape
    if yy.shape[0] != c or yy.shape[2] != d or variance.shape != (c,):
        raise ValueError(f"kernelmatrix: batch shapes differ: x {tuple(x.shape)}, y {tuple(yy.shape)}, "
                         f"variance {tuple(variance.shape)}")
    if x.dtype not in (torch.float32, torch.float64) or yy.dtype != x.dtype:
        raise TypeError(f"kernelmatrix: needs float32 or float64 inputs, got {x.dtype}/{yy.dtype}")
    if yy.device != x.device or variance.device != x.device:
        raise ValueError("kernelmatrix: inputs and variance must be on one CUDA device")
    var = variance.detach().to(x.dtype)
    m = yy.shape[1]
    out = torch.empty((c, n, m), dtype=x.dtype, device=x.device)
    lib = _lib()
    fn = (lib.stheno_kernelmatrix_batched_f32 if x.dtype == torch.float32
          else lib.stheno_kernelmatrix_batched_f64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), yy.data_ptr(), var.data_ptr(), out.data_ptr(), c, n, m, d,
                  KINDS[kind], int(same), x.stride(0), yy.stride(0), var.stride(0), stream)
    _build.check(lib, code, "kernelmatrix batched launch")
    BATCHED_LAUNCHES.add((c, n, m, d, same))
    return out


def kernelmatrix_batched_forward(x, y, kind: str, variance):
    """The batched kernel on CUDA tensors (x (C, N, D), y (C, M, D) or None,
    σ² (C,)), its batched plain version on CPU tensors."""
    if kind not in KINDS:
        raise ValueError(f"unknown stationary kernel {kind!r}")
    if x.is_cuda:
        return _launch_batched(x, y, kind, variance)
    return kernelmatrix_plain(x, y, kind, variance)


def km_se_d1_plain(x, variance=1.5):
    """σ²·exp(−½(x_i − x_j)²) of a vector x by broadcasting (the probe's
    `km_xla`, reference `scripts/perf_probe.py:46-48`)."""
    d = x[:, None] - x[None, :]
    return variance * torch.exp(-0.5 * d * d)


def km_se_d1(x, variance=1.5):
    """The same-input SE matrix σ²·exp(−½(x_i − x_j)²) of a vector x (N,):
    kernel 1's `<float, SE, D1>` instance on a CUDA tensor, the plain
    version on a CPU tensor.  Its diagonal is exactly σ² in both."""
    if x.dim() != 1:
        raise ValueError(f"km_se_d1: x must be a vector, got shape {tuple(x.shape)}")
    if not x.is_cuda:
        return km_se_d1_plain(x, variance)
    if not torch.is_tensor(variance):  # a fill on the card, not a copy from the host
        variance = torch.full((), variance, dtype=x.dtype, device=x.device)
    return _launch(x[:, None].contiguous(), None, "se", variance, KM_SE_D1_LAUNCHES)


def _chunk_rows(m: int) -> int:
    # ≈2^24 elements per temporary: 64 MiB in f32 at any width
    return max(1, (1 << 24) // max(m, 1))


def kernelmatrix_vjp(x, y, kind: str, variance, K_bar):
    """(x̄, ȳ, σ̄²) of K = σ²·g(‖x_i − y_j‖²) against the cotangent K̄, in
    row chunks: the plain version of the VJP kernel, and the reverse rule
    on a CPU tensor.  With dK/dx_i = σ² g'(sq) · 2(x_i − y_j):
    σ̄² = Σ K̄⊙g, x̄ the row and ȳ the column reductions of
    W⊙(x_i − y_j) with W = 2σ² K̄⊙g'.  Same-input calls (`y=None`) return
    x̄ + ȳ as x̄ and None as ȳ.

    Over a leading batch (x (C, N, D), y (C, M, D), σ² (C,), K̄ (C, N, M))
    each entry is the VJP of its own matrix, σ̄² (C,); a chunk then holds
    its rows of every batch entry."""
    same = y is None
    yy = x if same else y
    n, D = x.shape[-2:]
    batch = x.shape[:-2]
    gx = torch.zeros_like(x)
    gy = torch.zeros_like(yy)
    gv = torch.zeros(batch, dtype=x.dtype, device=x.device)
    two_var = _per_matrix(2.0 * variance.to(x.dtype))
    step = _chunk_rows(yy.shape[-2] * max(1, math.prod(batch)))
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        diffs = [x[..., r0:r1, k, None] - yy[..., None, :, k] for k in range(D)]
        sq = diffs[0] * diffs[0]
        for diff in diffs[1:]:
            sq = sq + diff * diff
        if same:
            sq.diagonal(offset=r0, dim1=-2, dim2=-1).zero_()
        g, dg = _epilogue_grad(kind, sq)
        Kb = K_bar[..., r0:r1, :]
        gv = gv + torch.sum(Kb * g, dim=(-2, -1))
        W = two_var * Kb * dg
        for k, diff in enumerate(diffs):
            t = W * diff
            gx[..., r0:r1, k] += t.sum(dim=-1)
            gy[..., :, k] -= t.sum(dim=-2)
    if same:
        return gx + gy, None, gv
    return gx, gy, gv


def kernelmatrix_vjp_abs_terms(x, y, kind: str, variance, K_bar):
    """For each output of `kernelmatrix_vjp`, the sum of its terms' absolute
    values (Σ|K̄⊙g|, Σ_j |W_ij (x_ik − y_jk)|, ...), in the same row chunks:
    the scale against which the VJP kernel's sums, added in another order,
    are held."""
    same = y is None
    yy = x if same else y
    n, D = x.shape[-2:]
    batch = x.shape[:-2]
    sx = torch.zeros_like(x)
    sy = torch.zeros_like(yy)
    sv = torch.zeros(batch, dtype=x.dtype, device=x.device)
    two_var = _per_matrix(2.0 * variance.to(x.dtype).abs())
    step = _chunk_rows(yy.shape[-2] * max(1, math.prod(batch)))
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        diffs = [(x[..., r0:r1, k, None] - yy[..., None, :, k]).abs() for k in range(D)]
        sq = diffs[0] * diffs[0]
        for diff in diffs[1:]:
            sq = sq + diff * diff
        if same:
            sq.diagonal(offset=r0, dim1=-2, dim2=-1).zero_()
        g, dg = _epilogue_grad(kind, sq)
        Kb = K_bar[..., r0:r1, :].abs()
        sv = sv + torch.sum(Kb * g.abs(), dim=(-2, -1))
        W = two_var * Kb * dg.abs()
        for k, diff in enumerate(diffs):
            t = W * diff
            sx[..., r0:r1, k] += t.sum(dim=-1)
            sy[..., :, k] += t.sum(dim=-2)
    if same:
        return sx + sy, None, sv
    return sx, sy, sv


@functools.lru_cache(maxsize=256)
def _vjp_plan(c: int, n: int, m: int, d: int, itemsize: int) -> tuple:
    """The VJP kernel's workspace: row-sum groups, column-sum groups and
    variance partials of a (c, n, m, d) problem (`csrc/kernelmatrix.cu`)."""
    lib = _lib()
    out = (ctypes.c_longlong * 3)()
    _build.check(lib, lib.stheno_kernelmatrix_vjp_plan(c, n, m, d, itemsize, out),
                 "kernelmatrix VJP plan")
    return tuple(out)


def _launch_vjp(x, y, kind: str, variance, K_bar):
    """The VJP kernel: what `kernelmatrix_vjp` returns, for x (N, D), y
    (M, D) or None, σ² with one element and K̄ (N, M), or over a batch: x
    (C, N, D), y (C, M, D) or None, σ² (C,), K̄ (C, N, M).  Each (N, D)
    slice of x and y must be contiguous (a batch stride of 0 is an operand
    shared by the batch); K̄ is read through its own strides, 0 included,
    and never copied: a transposed K̄ is the transposed problem's cotangent,
    run with x and y swapped.  The kernel's partial sums are added up over
    their group axis by `torch.sum`, in a fixed order."""
    if kind not in KINDS:
        raise ValueError(f"unknown stationary kernel {kind!r}")
    batched = x.dim() == 3
    same = y is None
    if not batched:
        x, K_bar, variance = x[None], K_bar[None], variance.reshape(1)
        y = None if same else y[None]
    yy = x if same else y
    for name, t in (("x", x), ("y", yy)):
        if t.dim() != 3 or not t[0].is_contiguous():
            raise ValueError(f"kernelmatrix VJP: {name} must be (N, D) or (C, N, D) with contiguous (N, D) slices")
    c, n, d = x.shape
    m = yy.shape[1]
    if yy.shape[0] != c or yy.shape[2] != d or variance.shape != (c,) or K_bar.shape != (c, n, m):
        raise ValueError(f"kernelmatrix VJP: shapes differ: x {tuple(x.shape)}, y {tuple(yy.shape)}, "
                         f"variance {tuple(variance.shape)}, K_bar {tuple(K_bar.shape)}")
    if x.dtype not in (torch.float32, torch.float64) or yy.dtype != x.dtype or K_bar.dtype != x.dtype:
        raise TypeError(f"kernelmatrix VJP: needs float32 or float64 inputs of one type, got "
                        f"{x.dtype}/{yy.dtype}/{K_bar.dtype}")
    if yy.device != x.device or variance.device != x.device or K_bar.device != x.device:
        raise ValueError("kernelmatrix VJP: inputs, variance and K_bar must be on one CUDA device")
    swap = K_bar.stride(2) != 1 and K_bar.stride(1) == 1
    a, b = (yy, x) if swap else (x, yy)
    kb = K_bar.transpose(1, 2) if swap else K_bar
    na, nb = a.shape[1], b.shape[1]
    groups_a, groups_b, groups_v = _vjp_plan(c, na, nb, d, x.element_size())
    var = variance.detach().to(x.dtype)
    size_a, size_b = c * groups_a * na * d, c * groups_b * nb * d
    work = torch.empty(size_a + size_b + c * groups_v, dtype=x.dtype, device=x.device)
    pa = work[:size_a].view(c, groups_a, na * d)
    pb = work[size_a:size_a + size_b].view(c, groups_b, nb * d)
    pv = work[size_a + size_b:].view(c, groups_v)
    lib = _lib()
    fn = lib.stheno_kernelmatrix_vjp_f32 if x.dtype == torch.float32 else lib.stheno_kernelmatrix_vjp_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(a.data_ptr(), b.data_ptr(), var.data_ptr(), kb.data_ptr(), pa.data_ptr(),
                  pb.data_ptr(), pv.data_ptr(), c, na, nb, d, KINDS[kind], int(same),
                  a.stride(0), b.stride(0), var.stride(0), kb.stride(0), kb.stride(1), kb.stride(2),
                  stream)
    _build.check(lib, code, "kernelmatrix VJP launch")
    VJP_LAUNCHES.add((c, n, m, d, same))
    ga = pa.sum(1).view(c, na, d)
    gb = pb.sum(1).view(c, nb, d)
    gv = pv.sum(1)
    if same:
        gx, gy = ga.add_(gb), None
    else:
        gx, gy = (gb, ga) if swap else (ga, gb)
    if batched:
        return gx, gy, gv
    return gx[0], None if gy is None else gy[0], gv[0]


def _vjp(x, y, kind: str, variance, K_bar):
    """The VJP kernel on a CUDA tensor, `kernelmatrix_vjp` on a CPU tensor."""
    if x.is_cuda:
        return _launch_vjp(x, y, kind, variance, K_bar)
    return kernelmatrix_vjp(x, y, kind, variance, K_bar)


def kernelmatrix_jvp(x, y, kind: str, variance, x_dot, y_dot, v_dot):
    """The tangent K̇ of K = σ²·g(‖x_i − y_j‖²) along (ẋ, ẏ, σ̇²), any of
    them None for a zero tangent, in row chunks:

        K̇ = σ²·g'(sq)·2Σ_k (x_ik − y_jk)(ẋ_ik − ẏ_jk) + σ̇²·g(sq).

    x (N, D) and y (M, D); `y=None` is the same-input call (y = x, ẏ = ẋ),
    whose diagonal difference is exactly zero.  Plain differentiable
    PyTorch throughout, so torch can differentiate the tangent again."""
    if y is None:
        y, y_dot = x, x_dot
    n, D = x.shape
    two_var = 2.0 * variance
    step = _chunk_rows(y.shape[0])
    chunks = []
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        diffs = [x[r0:r1, k, None] - y[None, :, k] for k in range(D)]
        sq = diffs[0] * diffs[0]
        for diff in diffs[1:]:
            sq = sq + diff * diff
        g, dg = _epilogue_grad(kind, sq)
        out = None
        if x_dot is not None or y_dot is not None:
            dsq = None
            for k, diff in enumerate(diffs):
                dd = None if x_dot is None else x_dot[r0:r1, k, None]
                if y_dot is not None:
                    yd = y_dot[None, :, k]
                    dd = -yd if dd is None else dd - yd
                t = diff * dd
                dsq = t if dsq is None else dsq + t
            out = two_var * dg * dsq
        if v_dot is not None:
            t = v_dot * g
            out = t if out is None else out + t
        if out is None:
            out = torch.zeros_like(sq)
        chunks.append(out)
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=-2)


def _to_front(info, in_dims, *args):
    """The operands of a `vmap` rule with their batch dimensions moved to
    the front; an unbatched tensor is expanded to the batch as a view."""
    out = []
    for a, bdim in zip(args, in_dims):
        if a is None:
            out.append(None)
        elif bdim is None:
            out.append(a.expand(info.batch_size, *a.shape))
        else:
            out.append(a.movedim(bdim, 0))
    return out


class _KernelMatrix(torch.autograd.Function):
    """K = σ²·g(‖x_i − y_j‖²) with hand-written backward and forward-mode
    rules and a batched `vmap` rule.  Saves only the inputs, never K, so
    callers may update K in place."""

    @staticmethod
    def forward(x, y, variance, kind):
        return kernelmatrix_forward(x, y, kind, variance)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, y, variance, kind = inputs
        ctx.kind = kind
        ctx.span = _trace.current()
        # absent tangents arrive as None, not as materialised zeros
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, y, variance)
        ctx.save_for_forward(x, y, variance)

    @staticmethod
    def jvp(ctx, x_dot, y_dot, v_dot, _):
        x, y, variance = ctx.saved_tensors
        kind = ctx.kind
        return lowered_jvp(lambda xx, yy, vv, *dots: kernelmatrix_jvp(xx, yy, kind, vv, *dots),
                           x, y, variance, x_dot, y_dot, v_dot)

    @staticmethod
    def backward(ctx, K_bar):
        x, y, variance = ctx.saved_tensors
        with _trace.span("cov.reverse", ctx.span):
            if under_transform():
                # torch.func: the VJP's own Function carries the batched rule
                gx, gy, gv = _KernelMatrixVJP.apply(x, y, variance, K_bar, ctx.kind)
            elif x.is_cuda:
                gx, gy, gv = _KernelMatrixVJPCard.apply(x, y, variance, K_bar, ctx.kind)
            else:
                gx, gy, gv = kernelmatrix_vjp(x, y, ctx.kind, variance, K_bar)
        need_x, need_y, need_v, _ = ctx.needs_input_grad
        return (gx if need_x else None, gy if need_y else None,
                gv if need_v else None, None)

    @staticmethod
    def vmap(info, in_dims, x, y, variance, kind):
        x, y, variance = _to_front(info, in_dims[:3], x, y, variance)
        x = x if x[0].is_contiguous() else x.contiguous()
        if y is not None and not y[0].is_contiguous():
            y = y.contiguous()
        return _KernelMatrixBatched.apply(x, y, variance, kind), 0


class _KernelMatrixBatched(torch.autograd.Function):
    """The batched launch with the batched VJP as its backward.  A `vmap`
    rule runs below every transform, so when ordinary autograd is what
    differentiates the vmapped call (`backward()` through a statistic that
    vmaps `kernelmatrix` itself, as the convolutional GP's `var2` does),
    only this Function records the launch, which autograd cannot see into.
    Under `torch.func.grad` its inputs carry no autograd history and it
    records nothing: `_KernelMatrix.backward` takes that case."""

    @staticmethod
    def forward(x, y, variance, kind):
        return kernelmatrix_batched_forward(x, y, kind, variance)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, y, variance, kind = inputs
        ctx.kind = kind
        ctx.span = _trace.current()
        ctx.save_for_backward(x, y, variance)

    @staticmethod
    def backward(ctx, K_bar):
        x, y, variance = ctx.saved_tensors
        with _trace.span("cov.reverse", ctx.span):
            if x.is_cuda:
                gx, gy, gv = _KernelMatrixVJPCard.apply(x, y, variance, K_bar, ctx.kind)
            else:
                gx, gy, gv = kernelmatrix_vjp(x, y, ctx.kind, variance, K_bar)
        need_x, need_y, need_v, _ = ctx.needs_input_grad
        return (gx if need_x else None, gy if need_y else None,
                gv if need_v else None, None)


class _KernelMatrixVJPCard(torch.autograd.Function):
    """The VJP kernel as the reverse rule on the card, outside `torch.func`.
    The launch is invisible to autograd, so a second differentiation cannot
    run through it: under `create_graph=True` this Function records a node
    whenever x, y, σ² or K̄ carries a graph, and differentiating its outputs
    reaches the once-differentiable backward below, which raises rather
    than dropping that part of the derivative.  (Twice differentiable:
    the plain route on a CPU tensor.)"""

    @staticmethod
    def forward(x, y, variance, K_bar, kind):
        return _launch_vjp(x, y, kind, variance, K_bar)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        raise RuntimeError("kernelmatrix: the VJP kernel on the card is once differentiable; "
                           "differentiate twice on CPU tensors, whose reverse rule is plain PyTorch")


class _KernelMatrixVJP(torch.autograd.Function):
    """The reverse rule as a Function, so that `torch.func.vmap` of the
    backward takes the batched VJP (one launch of the VJP kernel on the
    card, one chunked pass over the batch on the CPU) and never runs the
    in-place row updates on batched tensors."""

    @staticmethod
    def forward(x, y, variance, K_bar, kind):
        return _vjp(x, y, kind, variance, K_bar)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("kernelmatrix: the VJP under torch.func is not differentiable again")

    @staticmethod
    def vmap(info, in_dims, x, y, variance, K_bar, kind):
        x, y, variance, K_bar = _to_front(info, in_dims[:4], x, y, variance, K_bar)
        x = x if x[0].is_contiguous() else x.contiguous()
        if y is not None and not y[0].is_contiguous():
            y = y.contiguous()
        gx, gy, gv = _vjp(x, y, kind, variance, K_bar)
        return (gx, gy, gv), (0, None if gy is None else 0, 0)


def kernelmatrix(x, y, kind: str, variance):
    """K[i, j] = σ²·g(‖x_i − y_j‖²) for x (N, D) and y (M, D) (or `y=None`
    for the same-input matrix with its exact diagonal), lengthscale already
    folded in.  `variance` is a 0-d tensor; gradients flow to x, y and it.
    Under `torch.func.vmap` the whole batch is one batched launch."""
    return _KernelMatrix.apply(x, y, variance, kind)

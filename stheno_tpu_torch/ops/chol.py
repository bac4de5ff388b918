"""Cholesky, triangular solves and the MvNormal logpdf (counterpart of
`stheno_tpu/ops/chol.py:23-288`), and the sampler `mvn_sample_chol`.

`cholesky_psd` routes a single large matrix on a CUDA device (N ≥ 4096), or
any single matrix under `config.chol_backend("blocked")`, to the blocked
factorisation of `ops/blocked_cholesky.py`, which reads tril(K) only.
Everything else, a `torch.func.vmap` batch included, is symmetrised and
goes to `torch.linalg.cholesky`, as the reference sends it to
`lax.linalg.cholesky`.

`record_chol_sizes()` collects the (N, dtype) of every factor
`cholesky_psd` makes in its block (the samplers' `precision='auto'` rule).

`mvn_logpdf_psd` can route a single-vector logpdf to the fused form
(`_MvnLogpdfFused`), whose backward is the closed form ½(ααᵀ − K⁻¹) with
K⁻¹ built by the blocked triangular inverse (kernel 3 on its base blocks)
and a blocked LAUUM.  As in the reference it is off by default
(`LOGPDF_FUSED`); `config.logpdf_fused("auto" | "on")` scopes it in.

Spans (`utils/logging.py`): `cholesky_psd` is a `chol.factor` span and
`solve_lower`/`solve_upper` a `solve` span, on either route; the fused
logpdf's reverse rule is a `chol.reverse` span.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch

from stheno_tpu_torch import config as _cfg
from stheno_tpu_torch.func_transforms import is_vmapped
from stheno_tpu_torch.utils import logging as _trace

#: Cholesky backend: 'auto' routes large single matrices on a CUDA device to
#: the blocked factorisation, everything else to torch.linalg.
CHOL_BACKEND = "auto"

#: Minimum N for the blocked path under 'auto'.
_BLOCKED_MIN_N = 4096


def symmetrize(K):
    return 0.5 * (K + K.mT)


# ---------------------------------------------------------------------------
# Factorisation-size recording (reference `ops/chol.py:27-56`): lets policy
# code (the NUTS `precision='auto'` rule, `inference/hmc.py`) find what a
# log-density factorises.  The reference traces it with `jax.eval_shape`;
# here the log-density is evaluated once.  Thread-local, nestable, no cost
# when inactive.

_rec_tls = threading.local()


@contextmanager
def record_chol_sizes():
    """Collect the (N, dtype) of every Cholesky factor `cholesky_psd` makes
    in this block (an inner block collects its own, not the outer's)."""
    prev = getattr(_rec_tls, "sizes", None)
    _rec_tls.sizes = sizes = []
    try:
        yield sizes
    finally:
        _rec_tls.sizes = prev


def _record_n(n, dtype):
    sizes = getattr(_rec_tls, "sizes", None)
    if sizes is not None:
        sizes.append((int(n), dtype))


def add_jitter(K, jitter):
    """K + jitter·I (out of place)."""
    jitter = torch.as_tensor(jitter, dtype=K.dtype, device=K.device)
    return K.diagonal_scatter(K.diagonal(dim1=-2, dim2=-1) + jitter, dim1=-2, dim2=-1)


def _use_blocked(K):
    """Whether K takes the blocked route: a single matrix only.  A vmapped
    batch (one covariance per chain, which looks like one (N, N) matrix
    under `torch.func.vmap`) goes to `torch.linalg` under every backend, as
    the reference's vmapped factor goes to `lax.linalg`: the blocked path's
    Functions, ctypes launches and panel loops do not batch."""
    if is_vmapped(K):
        return False
    backend = _cfg.active_override("chol_backend", CHOL_BACKEND)
    if backend == "blocked":
        return K.dim() == 2
    if backend == "torch":
        return False
    return K.dim() == 2 and K.shape[-1] >= _BLOCKED_MIN_N and K.is_cuda


def cholesky_psd(K, jitter=None):
    """Lower Cholesky factor of a (batched) PSD matrix.

    The blocked route reads tril(K) only (the reference's
    `cholesky(Symmetric(K))` one-triangle read); the torch.linalg route
    symmetrises first.  A matrix that is not positive definite gives NaN,
    as in the reference, rather than raising."""
    _record_n(K.shape[-1], K.dtype)
    with _trace.span("chol.factor"):
        if _use_blocked(K):
            from stheno_tpu_torch.ops.blocked_cholesky import cholesky_blocked_padded

            if jitter is not None:
                K = add_jitter(K, jitter)
            return cholesky_blocked_padded(K, block=1024, base=256)
        K = symmetrize(K)
        if jitter is not None:
            K = add_jitter(K, jitter)
        L, info = torch.linalg.cholesky_ex(K)
        return L.masked_fill((info != 0)[..., None, None], float("nan"))


def solve_lower(L, b, trans=False):
    """Solve L x = b (or Lᵀ x = b when trans) with L lower triangular.
    Large single matrices take the blocked substitution."""
    with _trace.span("solve"):
        if _use_blocked(L):
            from stheno_tpu_torch.ops.blocked_cholesky import (
                blocked_solve_lower,
                blocked_solve_upper_T,
            )

            if trans:
                return blocked_solve_upper_T(L, b, block=1024)
            return blocked_solve_lower(L, b, block=1024)
        vec = b.dim() == L.dim() - 1
        b2 = b[..., None] if vec else b
        out = torch.linalg.solve_triangular(L.mT if trans else L, b2, upper=trans)
        return out[..., 0] if vec else out


def solve_upper(U, b, trans=False):
    with _trace.span("solve"):
        vec = b.dim() == U.dim() - 1
        b2 = b[..., None] if vec else b
        out = torch.linalg.solve_triangular(U.mT if trans else U, b2, upper=not trans)
        return out[..., 0] if vec else out


def chol_solve(L, b):
    """(L Lᵀ)⁻¹ b given the lower factor L."""
    return solve_lower(L, solve_lower(L, b), trans=True)


def chol_logdet(L):
    """log det (L Lᵀ) = 2 Σ log diag L."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def mvn_logpdf_chol(y, mean, L):
    """log N(y; mean, L Lᵀ); `y` may be (N,) or (N, S) for S iid samples."""
    n = L.shape[-1]
    diff = y - (mean[..., None] if y.dim() == mean.dim() + 1 else mean)
    alpha = solve_lower(L, diff)
    quad = torch.sum(alpha * alpha, dim=-2 if y.dim() > mean.dim() else -1)
    log_two_pi = torch.log(torch.tensor(2.0 * math.pi, dtype=L.dtype, device=L.device))
    return -0.5 * (n * log_two_pi + chol_logdet(L) + quad)


#: 'auto' takes the fused logpdf wherever the blocked Cholesky would be
#: used; 'on' and 'off' force.  Off by default, as in the reference, whose
#: fused path was the slower one on its TPU.
LOGPDF_FUSED = "off"


def _fused_forward(K, diff):
    """(value, L, z) of log N(diff; 0, K): `cholesky_psd`'s factor (the
    blocked one where the blocked route applies), then the blocked forward
    substitution z = L⁻¹ diff."""
    from stheno_tpu_torch.ops.blocked_cholesky import blocked_solve_lower

    n = K.shape[-1]
    L = cholesky_psd(K)
    z = blocked_solve_lower(L, diff)
    log_two_pi = math.log(2.0 * math.pi)
    val = -0.5 * (n * log_two_pi + chol_logdet(L) + torch.dot(z, z))
    return val, L, z


class _MvnLogpdfFused(torch.autograd.Function):
    """log N(diff; 0, K) for symmetric PSD K, with the closed-form gradient

        ∂logpdf/∂K = ½ (α αᵀ − K⁻¹),   α = K⁻¹ diff,

    in place of the reverse rule through the factorisation.  K⁻¹ is
    L⁻ᵀ L⁻¹: the blocked triangular inverse (its base blocks on the active
    base-case inverse, kernel 3 for f32) and a blocked LAUUM."""

    @staticmethod
    def forward(ctx, K, diff):
        from stheno_tpu_torch.ops.blocked_cholesky import _active_prec

        val, L, z = _fused_forward(K, diff)
        ctx.prec = _active_prec()
        ctx.span = _trace.current()
        ctx.save_for_backward(L, z)
        return val

    @staticmethod
    def backward(ctx, g):
        from stheno_tpu_torch.ops.blocked_cholesky import (
            blocked_lauum,
            blocked_solve_upper_T,
            blocked_tri_inv_lower,
        )

        L, z = ctx.saved_tensors
        # at the forward's GEMM precision, as the reference traces both in
        # one scope
        with _trace.span("chol.reverse", ctx.span), _cfg.scoped(gemm_precision=ctx.prec):
            alpha = blocked_solve_upper_T(L, z)
            K_bar = None
            if ctx.needs_input_grad[0]:
                K_inv = blocked_lauum(blocked_tri_inv_lower(L, base=256))
                K_bar = (0.5 * g) * (torch.outer(alpha, alpha) - K_inv)
        return K_bar, -g * alpha


def mvn_logpdf_psd(y, mean, K_sig):
    """log N(y; mean, K_sig) straight from the covariance.  A single
    vector `y` takes the fused logpdf under `config.logpdf_fused("on")`, or
    under "auto" where the blocked route applies; everything else goes
    through `cholesky_psd` and `mvn_logpdf_chol`."""
    mode = _cfg.active_override("logpdf_fused", LOGPDF_FUSED)
    fused = mode == "on" or (mode == "auto" and _use_blocked(K_sig))
    if fused and y.dim() == mean.dim() == 1:
        return _MvnLogpdfFused.apply(symmetrize(K_sig), y - mean)
    return mvn_logpdf_chol(y, mean, cholesky_psd(K_sig))


def mvn_sample_chol(generator, mean, L, sample_shape=()):
    """Samples of N(mean, L Lᵀ), shape (*sample_shape, N): mean + L ε with
    ε standard normal from `generator`: a `torch.Generator` on L's device,
    or on the CPU (ε is drawn there and moved, so one seed draws the same
    numbers on every device), or None for L's device's default one."""
    n = L.shape[-1]
    where = L.device if generator is None else generator.device
    eps = torch.randn((*sample_shape, n), generator=generator, dtype=L.dtype, device=where)
    return mean + torch.einsum("ij,...j->...i", L, eps.to(L.device))

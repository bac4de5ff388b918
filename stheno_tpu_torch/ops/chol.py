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

`mvn_logpdf_lowrank` takes a covariance given as a dense part and a part of
rank r (the constant terms of a process graph, `graph.split_constants`): it
factors the dense part alone and reads the rest through r × r products.

`mvn_logpdf_psd` can route a single-vector logpdf to the fused form
(`_MvnLogpdfFused`), whose backward is the closed form ½(ααᵀ − K⁻¹) with
K⁻¹ built by the blocked triangular inverse (kernel 3 on its base blocks)
and a blocked LAUUM.  As in the reference it is off by default
(`LOGPDF_FUSED`); `config.logpdf_fused("auto" | "on")` scopes it in.

`vfe_products` gives the pseudo-point bound's A Aᵀ, A b and Σ A² of
A = L⁻¹ K̃ with one closed-form reverse rule for the substitution and its
products (`_VfeProducts`); A Aᵀ is built from its lower blocks and mirrored
where M splits into leaves of `_SYM_LEAF` rows (`_sym_product`).

Spans (`utils/logging.py`): `cholesky_psd` is a `chol.factor` span and
`solve_lower`/`solve_upper` a `solve` span, on either route; the fused
logpdf's reverse rule is a `chol.reverse` span, and `_VfeProducts`'s a
`solve.reverse` span.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch

from stheno_tpu_torch import config as _cfg
from stheno_tpu_torch.func_transforms import is_vmapped, under_transform
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
            return cholesky_blocked_padded(K)
        K = symmetrize(K)
        if jitter is not None:
            K = add_jitter(K, jitter)
        L, info = torch.linalg.cholesky_ex(K)
        return L.masked_fill((info != 0)[..., None, None], float("nan"))


def _torch_solve(L, b, trans, upper=False):
    """The library solve of L x = b, or Lᵀ x = b with `trans`, for L lower
    (upper with `upper`) triangular and b a vector or a matrix."""
    vec = b.dim() == L.dim() - 1
    b2 = b[..., None] if vec else b
    out = torch.linalg.solve_triangular(L.mT if trans else L, b2, upper=trans != upper)
    return out[..., 0] if vec else out


def solve_lower(L, b, trans=False):
    """Solve L x = b (or Lᵀ x = b when trans) with L lower triangular.
    Large single matrices take the blocked substitution."""
    with _trace.span("solve"):
        if _use_blocked(L):
            from stheno_tpu_torch.ops.blocked_cholesky import blocked_solve_lower, blocked_solve_upper_T

            return (blocked_solve_upper_T if trans else blocked_solve_lower)(L, b)
        return _torch_solve(L, b, trans)


def _solve_plain(L, b, trans=False, stack=None):
    """`solve_lower`'s route with no span and no reverse rule of its own,
    for the inside of an autograd.Function: (x, stack), `blocked_solve`
    where `_use_blocked` sends L (against `stack`, the inverses of L's
    diagonal blocks, where given; the stack it applied comes back),
    `torch.linalg` otherwise (stack None)."""
    if _use_blocked(L):
        from stheno_tpu_torch.ops.blocked_cholesky import blocked_solve

        return blocked_solve(L, b, trans, stack)
    return _torch_solve(L, b, trans), None


def solve_upper(U, b, trans=False):
    with _trace.span("solve"):
        return _torch_solve(U, b, trans, upper=True)


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
            BASE,
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
                K_inv = blocked_lauum(blocked_tri_inv_lower(L, BASE))
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


def mvn_logpdf_lowrank(y, mean, K, U, a):
    """log N(y; mean, K + U diag(a²) Uᵀ) for PSD K (N × N), U (N × r) and
    amplitudes a (r,), on the factor L of K alone: with z = L⁻¹(y − mean),
    W = L⁻¹U (one substitution for both) and M = I + diag(a) WᵀW diag(a),

        log det = log det K + log det M,
        quad    = ‖z‖² − ‖M⁻¹ᐟ² diag(a) Wᵀz‖²

    (the determinant lemma and Woodbury's identity; M is r × r).  So a's
    gradient comes from r × r products of the substitution, where the
    dense route would sum the N × N cotangent of K over the blocks U spans:
    a sum that float32 cannot carry where K⁻¹'s entries are large and
    cancel.  `y` may be (N,) or (N, S)."""
    n = K.shape[-1]
    diff = y - (mean[..., None] if y.dim() == mean.dim() + 1 else mean)
    D = diff[:, None] if diff.dim() == 1 else diff
    s = D.shape[-1]
    L = cholesky_psd(K)
    Z = solve_lower(L, torch.cat([D, U.to(D)], dim=1))
    z, W = Z[:, :s], Z[:, s:] * a
    M = W.T @ W
    M.diagonal().add_(1.0)
    Lm = torch.linalg.cholesky_ex(M).L  # M ⪰ I: no check, so no wait for the device
    c = torch.linalg.solve_triangular(Lm, W.T @ z, upper=False)
    quad = torch.sum(z * z, dim=0) - torch.sum(c * c, dim=0)
    out = -0.5 * (n * math.log(2.0 * math.pi) + chol_logdet(L) + chol_logdet(Lm) + quad)
    return out[0] if diff.dim() == 1 else out


def _vfe_products_composite(L, Kt, b):
    """(A Aᵀ, A b, Σ A²) of A = L⁻¹ K̃ by the solve's reverse rule and
    autograd's: the route under a `torch.func` transform."""
    A = solve_lower(L, Kt)
    return A @ A.T, A @ b, torch.sum(A * A)


#: Fewest rows of a diagonal leaf of `_sym_product`.
_SYM_LEAF = 1024


def _sym_product(A):
    """A Aᵀ of A (M × N) from its lower blocks, mirrored.  d is the most
    halvings of M's rows that leave whole leaves of `_SYM_LEAF` rows or
    more; at each level ℓ = 1 … d the sibling halves (X₁, X₂) of every
    block give X₂ X₁ᵀ in one strided batched product on views of A, the 2^d
    leaves A_i A_iᵀ one more, and the strict lower triangle is copied onto
    the upper, so the result is exactly symmetric.  With d = 0, `A @ A.T`.
    Where it splits, it credits `vfe.sym` on the open span."""
    m, n = A.shape
    d = 0
    while m % 2 ** (d + 1) == 0 and m >> (d + 1) >= _SYM_LEAF:
        d += 1
    if d == 0:
        return A @ A.T
    if _trace.active:
        _trace.credit("vfe.sym", 1)
    B = A.new_empty(m, m)
    for lvl in range(1, d + 1):
        g, h = 1 << (lvl - 1), m >> lvl
        X = A.view(g, 2, h, n)
        # block k of the level sits at rows (2k + 1)h, columns 2kh
        torch.bmm(X[:, 1], X[:, 0].mT, out=B.as_strided((g, h, h), (2 * h * (m + 1), m, 1), h * m))
    h = m >> d
    X = A.view(1 << d, h, n)
    torch.bmm(X, X.mT, out=B.as_strided((1 << d, h, h), (h * (m + 1), m, 1)))
    i = torch.arange(m, device=A.device)
    return torch.where(i[:, None] >= i, B, B.mT)


class _VfeProducts(torch.autograd.Function):
    """(B', a, t) = (A Aᵀ, A b, Σ A²) of A = L⁻¹ K̃ (M × N), the pseudo-point
    bound's substitution and its products, with one reverse rule for all of
    them.  With S' = B̄' + B̄'ᵀ + 2 t̄ I, P = L⁻ᵀ S' and w = L⁻ᵀ ā:

        K̃̄ = P A + w bᵀ,   L̄ = −tril(P B' + w aᵀ),   b̄ = Aᵀ ā,

    one M × M × N product where the composite chain takes a substitution on
    the M × N cotangent and three such products (`docs/internals.md`).  The
    forward is the composite chain's, the substitution under its `solve`
    span, but for B' = `_sym_product(A)`, the lower blocks of A Aᵀ mirrored;
    its stack of L's diagonal-block inverses is kept for P and w, so
    the reverse rule builds none.  The reverse rule is a `solve.reverse`
    span at the forward's GEMM precision, counted `vfe.fused`.  A is saved
    detached from K̃, so the rule is once differentiable: under
    `create_graph=True` it raises, and second derivatives go through
    `torch.func`, whose transforms take the composite chain."""

    @staticmethod
    def forward(ctx, L, Kt, b):
        from stheno_tpu_torch.ops.blocked_cholesky import _active_prec

        with _trace.span("solve"):
            A, stack = _solve_plain(L, Kt)
        Bp, a, t = _sym_product(A), A @ b, torch.sum(A * A)
        ctx.prec = _active_prec()
        ctx.span = _trace.current()
        ctx.save_for_backward(L, A, b, Bp, a, stack)
        return Bp, a, t

    @staticmethod
    def backward(ctx, gB, ga, gt):
        from stheno_tpu_torch.ops.blocked_cholesky import _mm

        if torch.is_grad_enabled():
            raise RuntimeError("vfe_products: the fused reverse rule is once differentiable; "
                               "take second derivatives under torch.func (grad, jacrev, hessian), "
                               "which runs the composite chain")
        L, A, b, Bp, a, stack = ctx.saved_tensors
        need_L, need_K, need_b = ctx.needs_input_grad
        L_bar = K_bar = b_bar = None
        with _trace.span("solve.reverse", ctx.span), _cfg.scoped(gemm_precision=ctx.prec):
            if _trace.active:
                _trace.credit("vfe.fused", 1)
            if need_L or need_K:
                S = gB + gB.T
                S.diagonal().add_(2.0 * gt)
                P, _ = _solve_plain(L, S, trans=True, stack=stack)
                w, _ = _solve_plain(L, ga, trans=True, stack=stack)
                if need_K:
                    K_bar = _mm(P, A).addr_(w, b)
                if need_L:
                    L_bar = _mm(P, Bp).addr_(w, a).tril_().neg_()
            if need_b:
                b_bar = _mm(A.T, ga)
        return L_bar, K_bar, b_bar


def vfe_products(L, Kt, b):
    """(B', a, t) = (A Aᵀ, A b, Σ A²) of A = L⁻¹ K̃, for L lower triangular
    (M × M), K̃ (M × N) and b (N,): `_VfeProducts`, whose reverse rule does
    half the work of the composite chain's.  Under a `torch.func` transform
    the composite chain (`solve_lower`, then the products), as `_use_blocked`
    sends a vmapped factor to `torch.linalg`; taken with grad enabled, it is
    counted `vfe.composite`."""
    if under_transform():
        if _trace.active and torch.is_grad_enabled():
            _trace.credit("vfe.composite", 1)
        return _vfe_products_composite(L, Kt, b)
    return _VfeProducts.apply(L, Kt, b)


def mvn_sample_chol(generator, mean, L, sample_shape=()):
    """Samples of N(mean, L Lᵀ), shape (*sample_shape, N): mean + L ε with
    ε standard normal from `generator`: a `torch.Generator` on L's device,
    or on the CPU (ε is drawn there and moved, so one seed draws the same
    numbers on every device), or None for L's device's default one."""
    n = L.shape[-1]
    where = L.device if generator is None else generator.device
    eps = torch.randn((*sample_shape, n), generator=generator, dtype=L.dtype, device=where)
    return mean + torch.einsum("ij,...j->...i", L, eps.to(L.device))

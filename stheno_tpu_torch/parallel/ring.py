"""Ring blockwise kernel evaluation and matrix-free CG inference
(counterpart of `stheno_tpu/parallel/ring.py`).

Where `parallel.big` shards the storage of K (each rank holds an
(N/P)×N slab), this module removes the O(N²) storage: the only kernel
blocks ever made are (N/P)×(N/P), computed by kernel 1 against input shards
passed around a ring (`batch_isend_irecv`).  At P = 1 there is no send and
the one block is the whole N×N matrix.

The ring functions take what the reference's callers place with
`shard_rows`: on each rank, its shard of `x`, `y` and the right-hand
sides, with query points `xs` whole.  Inner products over N are `psum`s.

- `ring_matvec(mesh, kernel, x, v, noise=...)`: y = (K(x,x)+σ²I) v, K-free;
- `pcg_solve(matvec, b)`: batched preconditioned CG, a Python loop with one
  host check of convergence per iteration (the reference's
  `lax.while_loop`); returns the iterations run;
- `ring_gp_solve`, `ring_posterior_mean_var`: CG through the ring;
- `lanczos_tridiag`, `slq_logdet`: stochastic Lanczos quadrature;
- `ring_gp_logpdf`: CG quadratic term, SLQ logdet and the Hutchinson
  backward (`_RingLogpdf`, the reference's custom VJP).

Nothing here is differentiated through the CG loop (the reference's
`while_loop` is not differentiable in reverse mode either):
`ring_gp_logpdf` carries its own backward.
"""

from __future__ import annotations

import math

import torch

from stheno_tpu_torch.finite_gp import _add_diag
from stheno_tpu_torch.ops.blocked_cholesky import _mm
from stheno_tpu_torch.parallel.collectives import (
    Axis,
    map_tensors,
    ppermute,
    psum,
    pvary,
    pvary_tree,
)


def ring_matvec(mesh, kernel, x, v, noise=None, axis_name="rows"):
    """This rank's rows of (K(x, x) + noise·I) v, without K anywhere.

    `x`: this rank's (N/P,) or (N/P, D) inputs; `v`: its (N/P,) or
    (N/P, K) right-hand sides.  Each of the P ring steps computes one
    (N/P)×(N/P) block against the input shard in hand, then passes the
    (input, RHS) pair to the next rank."""
    ax = Axis(mesh, axis_name)
    vec = v.dim() == 1
    v2 = v[:, None] if vec else v
    k = pvary_tree(kernel, ax)
    blk_x, blk_v = x, v2
    y = None
    for s in range(ax.size):
        K_blk = k.matrix(x, blk_x)  # (n_loc, n_loc)
        if noise is not None and s == 0:
            # every rank starts with its own shard: the diagonal block is in
            # hand exactly at step 0
            K_blk = _add_diag(K_blk, pvary(noise, ax))
        term = _mm(K_blk, blk_v.to(K_blk.dtype))
        y = term if y is None else y + term
        if s < ax.size - 1:
            blk_x = ppermute(blk_x, ax)
            blk_v = ppermute(blk_v, ax)
    y = y.to(v.dtype)
    return y[:, 0] if vec else y


def _colsum(a, ax):
    """Σ over rows of a (N-row) array: a psum of local sums when the rows
    are sharded over `ax`."""
    s = torch.sum(a, dim=0)
    return s if ax is None else psum(s, ax)


def pcg_solve(matvec, b, precond=None, tol=1e-10, maxiter=1000, mesh=None, axis_name="rows"):
    """Solve A x = b for an SPD `matvec` by (optionally preconditioned)
    conjugate gradients, batched over RHS columns.

    `b`: (N,) or (N, K), or with `mesh` this rank's rows of it (the inner
    products are then psum'd over `axis_name`).  `precond` applies M⁻¹
    (e.g. Jacobi).  Stops when every column's residual norm ≤ tol·‖b‖ or at
    `maxiter`, with one host check a step.  Returns (x, iterations)."""
    ax = None if mesh is None else Axis(mesh, axis_name)
    vec = b.dim() == 1
    b2 = (b[:, None] if vec else b).detach()
    M = precond if precond is not None else (lambda r: r)

    def mv(X):
        out = matvec(X[:, 0] if vec else X)
        return out[:, None] if vec else out

    with torch.no_grad():
        atol2 = (tol * torch.sqrt(_colsum(b2 * b2, ax))) ** 2
        x = torch.zeros_like(b2)
        r = b2
        z = M(r)
        p = z
        rz = _colsum(r * z, ax)
        k = 0
        while k < maxiter:
            active = _colsum(r * r, ax) > atol2
            if not bool(active.any()):
                break
            Ap = mv(p)
            denom = _colsum(p * Ap, ax)
            # converged columns: freeze (alpha = 0) instead of dividing by ~0
            alpha = torch.where(active, rz / torch.where(denom == 0, 1.0, denom), 0.0)
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * Ap
            z = M(r)
            rz_new = _colsum(r * z, ax)
            beta = torch.where(active, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
            p = z + beta[None, :] * p
            rz = rz_new
            k += 1
    return (x[:, 0] if vec else x), k


def ring_gp_solve(mesh, kernel, x, b, noise, tol=1e-10, maxiter=1000, axis_name="rows"):
    """(K(x,x)+σ²I)⁻¹ b by CG over the ring matvec, Jacobi-preconditioned
    (the diagonal k(x,x)+σ² is local): `x` and `b` this rank's rows; returns
    this rank's rows of the solution and the iterations."""
    with torch.no_grad():
        diag = kernel.diag_same(x) + torch.as_tensor(noise, dtype=b.dtype, device=b.device)

    def precond(r):
        return r / (diag[:, None] if r.dim() == 2 else diag)

    def mv(v):
        return ring_matvec(mesh, kernel, x, v, noise=noise, axis_name=axis_name)

    return pcg_solve(mv, b, precond=precond, tol=tol, maxiter=maxiter, mesh=mesh,
                     axis_name=axis_name)


def ring_posterior_mean_var(mesh, kernel, x, y, noise, xs, tol=1e-10, maxiter=1000,
                            axis_name="rows"):
    """Exact zero-mean GP posterior marginals at `xs` (whole, Np small) from
    this rank's shard of the training data, with no N×N object anywhere:

        mean = Ks α,   α = (K+σ²I)⁻¹ y                  (one CG solve)
        var  = diag(Kss) − Σ_j Ks[:, j]·V[j, :],  V = (K+σ²I)⁻¹ Ksᵀ
                                                    (an Np-column CG solve)

    Returns (mean, var, (iterations of the two solves)), whole on every rank."""
    ax = Axis(mesh, axis_name)
    with torch.no_grad():
        alpha, it1 = ring_gp_solve(mesh, kernel, x, y, noise, tol=tol, maxiter=maxiter,
                                   axis_name=axis_name)
        Ks_T = kernel.matrix(x, xs)  # this rank's (N/P, Np) rows of K(x, xs)
        V, it2 = ring_gp_solve(mesh, kernel, x, Ks_T, noise, tol=tol, maxiter=maxiter,
                               axis_name=axis_name)
        m = psum(_mm(Ks_T.T, alpha), ax)
        q = psum(torch.sum(Ks_T * V, dim=0), ax)
        var = kernel.diag_same(xs) - q
    return m, var, (it1, it2)


def lanczos_tridiag(matvec, V0, m, reorth=True, mesh=None, axis_name="rows"):
    """Batched Lanczos tridiagonalisation from unit-norm start columns `V0`
    (N, P) (with `mesh`, this rank's rows), `m` steps.  Returns
    (alphas (m, P), betas (m-1, P)).  With `reorth` each new vector is
    re-orthogonalised against the stored basis (full reorthogonalisation,
    the f32-stable choice)."""
    ax = None if mesh is None else Axis(mesh, axis_name)
    with torch.no_grad():
        v = V0
        v_prev = torch.zeros_like(V0)
        beta_prev = torch.zeros(V0.shape[1], dtype=V0.dtype, device=V0.device)
        alphas, betas, basis = [], [], [V0]
        for k in range(m):
            w = matvec(v) - beta_prev[None, :] * v_prev
            a = _colsum(w * v, ax)
            w = w - a[None, :] * v
            if reorth:
                Vb = torch.stack(basis)  # (k+1, N, P)
                proj = torch.einsum("knp,np->kp", Vb, w)
                proj = proj if ax is None else psum(proj, ax)
                w = w - torch.einsum("knp,kp->np", Vb, proj)
            alphas.append(a)
            if k < m - 1:
                b = torch.sqrt(_colsum(w * w, ax))
                betas.append(b)
                v_prev, beta_prev = v, b
                v = w / torch.clamp(b, min=torch.finfo(w.dtype).tiny)[None, :]
                if reorth:
                    basis.append(v)
        betas = torch.stack(betas) if betas else torch.zeros((0, V0.shape[1]), dtype=V0.dtype,
                                                              device=V0.device)
    return torch.stack(alphas), betas


def slq_logdet(matvec, generator, n, m=25, num_probes=16, dtype=torch.float64, device=None,
               mesh=None, axis_name="rows"):
    """Stochastic Lanczos quadrature estimate of log det(A) for an SPD
    `matvec` (Ubaru, Chen and Saad 2017).

    Rademacher probes Z (N, num_probes) from `generator` (drawn whole on
    every rank, each keeping its rows when `mesh` is given), m-step Lanczos
    per probe, then logdet ≈ (n/P)·Σᵢ Σⱼ (e₁ᵀuⱼ)² log λⱼ(Tᵢ), the
    eigenvalues of T clamped below at tiny.  Returns (estimate, Z) with Z
    this rank's rows."""
    device = device if device is not None else (generator.device if generator is not None else None)
    Z = torch.where(torch.rand((n, num_probes), generator=generator, device=device) < 0.5, 1.0, -1.0)
    Z = Z.to(dtype)
    if mesh is not None:
        a, b = Axis(mesh, axis_name).rows(n)
        Z = Z[a:b]
    V0 = Z / math.sqrt(n)
    alphas, betas = lanczos_tridiag(matvec, V0, m, mesh=mesh, axis_name=axis_name)
    T = torch.diag_embed(alphas.T)
    if m > 1:
        T = T + torch.diag_embed(betas.T, offset=1) + torch.diag_embed(betas.T, offset=-1)
    w, U = torch.linalg.eigh(T)
    w = torch.clamp(w, min=torch.finfo(dtype).tiny)
    quad = torch.sum(U[:, 0, :] ** 2 * torch.log(w), dim=-1)  # e₁ weights
    return n * torch.mean(quad), Z


def _float_leaves(obj):
    """The floating tensors inside a kernel (its hyperparameters)."""
    leaves = []
    map_tensors(obj, lambda t: leaves.append(t) or t if t.is_floating_point() else t)
    return leaves


def _with_leaves(obj, new):
    """`obj` with its floating tensors replaced by `new`, in order."""
    it = iter(new)
    return map_tensors(obj, lambda t: next(it) if t.is_floating_point() else t)


class _RingLogpdf(torch.autograd.Function):
    """The ring logpdf with the Hutchinson backward (reference
    `ring.py:254-335`):

        d logpdf = ½ αᵀ(dK̂)α − ½ tr(K̂⁻¹ dK̂),

    the trace by the SLQ probes, tr(K̂⁻¹ dK̂) ≈ (1/P) Σᵢ wᵢᵀ (dK̂) zᵢ with
    wᵢ = K̂⁻¹zᵢ, through the gradient of a surrogate at frozen α, W and Z:
    two ring matvecs.  The y-gradient −α is exact."""

    @staticmethod
    def forward(ctx, settings, kernel, x, y, noise, *leaves):
        mesh, axis_name, num_probes, m, tol, maxiter, generator, n = settings
        ax = Axis(mesh, axis_name)

        def mv(V):
            return ring_matvec(mesh, kernel, x, V, noise=noise, axis_name=axis_name)

        alpha, _ = ring_gp_solve(mesh, kernel, x, y, noise, tol=tol, maxiter=maxiter,
                                 axis_name=axis_name)
        logdet, Z = slq_logdet(mv, generator, n, m=m, num_probes=num_probes, dtype=y.dtype,
                               device=y.device, mesh=mesh, axis_name=axis_name)
        W, _ = ring_gp_solve(mesh, kernel, x, Z, noise, tol=tol, maxiter=maxiter,
                             axis_name=axis_name)
        quad = psum(torch.dot(y, alpha), ax)
        ctx.settings, ctx.kernel = settings, kernel
        ctx.save_for_backward(x, noise, alpha, Z, W, *leaves)
        return -0.5 * (n * math.log(2.0 * math.pi) + logdet + quad)

    @staticmethod
    def backward(ctx, g):
        mesh, axis_name, num_probes = ctx.settings[:3]
        ax = Axis(mesh, axis_name)
        x, noise, alpha, Z, W, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            xs = x.detach().requires_grad_(need[2])
            ns = noise.detach().requires_grad_(need[4])
            ls = [t.detach().requires_grad_(nd) for t, nd in zip(leaves, need[5:])]
            kern = _with_leaves(ctx.kernel, ls)
            Ka = ring_matvec(mesh, kern, xs, alpha, noise=ns, axis_name=axis_name)
            KZ = ring_matvec(mesh, kern, xs, Z, noise=ns, axis_name=axis_name)
            s = psum(0.5 * torch.dot(alpha, Ka) - (0.5 / num_probes) * torch.sum(W * KZ), ax)
            wrt = [t for t, nd in zip([xs, ns, *ls], [need[2], need[4], *need[5:]]) if nd]
            grads = iter(torch.autograd.grad(s, wrt, grad_outputs=g, allow_unused=True)) if wrt else iter(())
        gx = next(grads) if need[2] else None
        gn = next(grads) if need[4] else None
        gl = [next(grads) if nd else None for nd in need[5:]]
        gy = -g * alpha if need[3] else None
        return (None, None, gx, gy, gn, *gl)


def ring_gp_logpdf(mesh, kernel, x, y, noise, generator, num_probes=16, lanczos_iters=25,
                   tol=1e-10, maxiter=1000, axis_name="rows"):
    """Stochastic exact-GP log-marginal likelihood, matrix-free: the
    quadratic term by CG (machine precision), the logdet by stochastic
    Lanczos quadrature, gradients by the Hutchinson estimator reusing the
    SLQ probes (the BBMM estimator of Gardner et al. 2018 on the ring).

    `x`, `y`: this rank's shards; `noise` a number or 0-d tensor.
    Differentiable in the kernel's hyperparameters, `x`, `y` and `noise`
    (two ring matvecs a backward, no factorisation anywhere).
    `generator` (a `torch.Generator`, seeded alike on every rank) draws the
    probes: a fixed seed gives a deterministic estimate."""
    ax = Axis(mesh, axis_name)
    n = x.shape[0] * ax.size
    noise = torch.as_tensor(noise, dtype=y.dtype, device=y.device)
    leaves = _float_leaves(kernel)
    settings = (mesh, axis_name, num_probes, lanczos_iters, tol, maxiter, generator, n)
    return _RingLogpdf.apply(settings, kernel, x, y, noise, *leaves)

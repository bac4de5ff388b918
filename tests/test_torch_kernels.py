"""Port vs reference for the modules that hold the three kernels:
`stheno_tpu_torch.cuda.kernelmatrix` (kernel 1) and
`stheno_tpu_torch.cuda.chol_block` (kernels 2 and 3).

On the CPU each wrapper runs its plain PyTorch version; the same numpy-seeded
inputs go through the JAX package (its XLA path, and its Pallas kernels in
interpret mode, as tests/test_ops.py runs them).  The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as st
import stheno_tpu_torch as stt
from stheno_tpu.experimental.pallas.chol_block import chol_block_auto, tri_inv_block_auto
from stheno_tpu.experimental.pallas.kernelmatrix import pairwise_kernelmatrix
from stheno_tpu.ops import blocked_cholesky as jbc
from stheno_tpu_torch.cuda import chol_block as tcb
from stheno_tpu_torch.cuda import kernelmatrix as tkm
from stheno_tpu_torch.ops import blocked_cholesky as tbc
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

KINDS = {
    "se": (st.SEKernel, stt.SEKernel),
    "matern12": (st.Matern12Kernel, stt.Matern12Kernel),
    "matern32": (st.Matern32Kernel, stt.Matern32Kernel),
    "matern52": (st.Matern52Kernel, stt.Matern52Kernel),
}


def _inputs(seed, n, m, dim, dtype=np.float64):
    rng = np.random.default_rng(seed)
    shape = lambda k: (k, dim) if dim > 1 else (k,)
    x = rng.normal(size=shape(n)).astype(dtype)
    y = rng.normal(size=shape(m)).astype(dtype)
    ell = np.asarray(np.resize([0.7, 1.3, 2.1], dim) if dim > 1 else 0.8, dtype=dtype)
    return x, y, ell


def _kernels(kind, variance, ell):
    jk, tk = KINDS[kind]
    jkern = variance * st.with_lengthscale(jk(), jnp.asarray(ell))
    tkern = torch.tensor(variance, dtype=torch.float64) * stt.with_lengthscale(
        tk(), torch.as_tensor(ell))
    return jkern, tkern


@pytest.mark.parametrize("same", [True, False], ids=["same", "cross"])
@pytest.mark.parametrize("dim", [1, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_kernelmatrix_matches_reference(kind, dim, same):
    x, y, ell = _inputs(0, 96, 64, dim)
    jkern, tkern = _kernels(kind, 1.7, ell)
    if same:
        K_ref = st.kernelmatrix(jkern, jnp.asarray(x))
        K = stt.kernelmatrix(tkern, torch.as_tensor(x))
    else:
        K_ref = st.kernelmatrix(jkern, jnp.asarray(x), jnp.asarray(y))
        K = stt.kernelmatrix(tkern, torch.as_tensor(x), torch.as_tensor(y))
    # f64; the two libraries' exp and (for D=3) the reference's matmul-
    # identity distance differ from the direct difference in the last bits
    np.testing.assert_allclose(K.numpy(), np.asarray(K_ref), rtol=1e-12, atol=1e-14)
    if same:
        np.testing.assert_array_equal(np.diagonal(K.numpy()), np.full(96, 1.7))


@pytest.mark.parametrize("dim", [1, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_kernelmatrix_matches_pallas_interpret(kind, dim):
    x, y, ell = _inputs(1, 256, 128, dim, np.float32)
    K_ref = pairwise_kernelmatrix(jnp.asarray(x), jnp.asarray(y), name=kind, variance=1.3,
                                  lengthscale=jnp.asarray(ell), tile_m=128, tile_n=128)
    xs = stt.ops.ensure_2d(torch.as_tensor(x) / torch.as_tensor(ell)).contiguous()
    ys = stt.ops.ensure_2d(torch.as_tensor(y) / torch.as_tensor(ell)).contiguous()
    K = tkm.kernelmatrix_forward(xs, ys, kind, torch.tensor(1.3))
    # 2e-4: the Pallas kernel uses the matmul-identity sqdist in f32, the
    # port the exact direct difference (tests/test_ops.py:87-89)
    np.testing.assert_allclose(K.numpy(), np.asarray(K_ref), atol=2e-4)
    K_same = tkm.kernelmatrix_forward(xs, None, kind, torch.tensor(1.3))
    K_same_ref = pairwise_kernelmatrix(jnp.asarray(x), name=kind, variance=1.3,
                                       lengthscale=jnp.asarray(ell), tile_m=128, tile_n=128)
    # Matern12 has a kink at 0: there the identity's f32 error in d (up to
    # sqrt(eps)·|x| for near-duplicate points) reaches K unattenuated
    np.testing.assert_allclose(K_same.numpy(), np.asarray(K_same_ref),
                               atol=1e-3 if kind == "matern12" else 2e-4)
    np.testing.assert_array_equal(np.diagonal(K_same.numpy()), np.float32(1.3))


@pytest.mark.parametrize("same", [True, False], ids=["same", "cross"])
@pytest.mark.parametrize("dim", [1, 2, 3, 4, 9])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kernelmatrix_gradient_matches_jax(kind, dim, same):
    """The hand-written backward (∂σ², ∂ℓ, ∂x) against jax.grad of Σ W⊙K."""
    x, y, ell = _inputs(2, 80, 56, dim)
    rng = np.random.default_rng(3)
    W = rng.normal(size=(80, 80 if same else 56))
    jk, tk = KINDS[kind]

    def jloss(v, l, xx):
        k = v * st.with_lengthscale(jk(), l)
        K = st.kernelmatrix(k, xx) if same else st.kernelmatrix(k, xx, jnp.asarray(y))
        return jnp.sum(jnp.asarray(W) * K)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(1.7, jnp.asarray(ell), jnp.asarray(x))

    v = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
    l = torch.tensor(ell, requires_grad=True)
    xx = torch.tensor(x, requires_grad=True)
    k = v * stt.with_lengthscale(tk(), l)
    K = stt.kernelmatrix(k, xx) if same else stt.kernelmatrix(k, xx, torch.as_tensor(y))
    tg = torch.autograd.grad(torch.sum(torch.as_tensor(W) * K), (v, l, xx))
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-12 * np.abs(b).max())


@pytest.mark.parametrize("same", [True, False], ids=["same", "cross"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batched_kernelmatrix_vjp_matches_jax_vmap(kind, same):
    """The batched reverse rule at D = 9 (the convolutional GP's patches;
    what the VJP kernel is held against on the card), directly and under
    `torch.func.vmap(grad)`, against `jax.vmap` of the JAX package's VJP of
    its kernel matrix, per entry (rtol 1e-9)."""
    rng = np.random.default_rng(16)
    C, n, m, d = 3, 40, 28, 9
    x = rng.normal(size=(C, n, d)) / 2
    y = x if same else rng.normal(size=(C, m, d)) / 2
    v = rng.uniform(0.5, 2.0, size=C)
    K_bar = rng.normal(size=(C, n, n if same else m))
    jk, _ = KINDS[kind]

    def jax_vjp(vb, xb, yb, kb):
        f = (lambda vv, xx: st.kernelmatrix(vv * jk(), xx)) if same else (
            lambda vv, xx: st.kernelmatrix(vv * jk(), xx, yb))
        _, pull = jax.vjp(f, vb, xb)
        return pull(kb)

    jv, jx = jax.vmap(jax_vjp)(jnp.asarray(v), jnp.asarray(x), jnp.asarray(y), jnp.asarray(K_bar))
    T = torch.as_tensor
    gx, _, gv = tkm.kernelmatrix_vjp(T(x), None if same else T(y), kind, T(v), T(K_bar))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=1e-9, atol=1e-12 * np.abs(jx).max())
    np.testing.assert_allclose(gv.numpy(), np.asarray(jv), rtol=1e-9)

    def weighted(vv, xx, kb, yy):
        return torch.sum(kb * tkm.kernelmatrix(xx, None if same else yy, kind, vv))

    tv, tx = torch.func.vmap(torch.func.grad(weighted, argnums=(0, 1)))(T(v), T(x), T(K_bar), T(y))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9, atol=1e-12 * np.abs(jx).max())
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9)


@pytest.mark.parametrize("dim", [1, 9])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kernelmatrix_vjp_abs_terms(kind, dim):
    """The scale the VJP kernel is held against on the card: where no term
    cancels (every x below every y in each coordinate, K̄ ≥ 0, so each term
    of x̄ is ≥ 0 and of ȳ ≤ 0) it is the VJP itself, with ȳ negated; under
    a cotangent of either sign it bounds the VJP and ignores K̄'s signs."""
    rng = np.random.default_rng(19)
    T = torch.as_tensor
    x = T(rng.uniform(-3.0, -1.0, size=(30, dim)))
    y = T(rng.uniform(1.0, 3.0, size=(20, dim)))
    v = T(1.3)
    K_bar = T(rng.uniform(0.0, 1.0, size=(30, 20)))
    gx, gy, gv = tkm.kernelmatrix_vjp(x, y, kind, v, K_bar)
    sx, sy, sv = tkm.kernelmatrix_vjp_abs_terms(x, y, kind, v, K_bar)
    torch.testing.assert_close(sx, gx, rtol=1e-12, atol=0)
    torch.testing.assert_close(sy, -gy, rtol=1e-12, atol=0)
    torch.testing.assert_close(sv, gv, rtol=1e-12, atol=0)
    K_bar = T(rng.normal(size=(30, 30)))
    x = T(rng.normal(size=(30, dim)))
    gx, _, gv = tkm.kernelmatrix_vjp(x, None, kind, v, K_bar)
    sx, sy, sv = tkm.kernelmatrix_vjp_abs_terms(x, None, kind, v, K_bar)
    assert sy is None and bool((gx.abs() <= sx).all()) and bool(gv.abs() <= sv)
    flipped = tkm.kernelmatrix_vjp_abs_terms(x, None, kind, -v, -K_bar)
    torch.testing.assert_close(flipped[0], sx, rtol=0, atol=0)
    torch.testing.assert_close(flipped[2], sv, rtol=0, atol=0)


@pytest.mark.parametrize("same", [True, False], ids=["same", "cross"])
@pytest.mark.parametrize("kind", ["se", "matern32", "matern52"])
def test_kernelmatrix_second_derivative_on_cpu_matches_jax(kind, same):
    """On CPU tensors the reverse rule is plain PyTorch and differentiable
    again: with L = Σ W⊙K, ∂/∂σ² and ∂/∂x of ⟨∂L/∂x, u⟩ through
    `create_graph=True` match JAX's second derivatives (rtol 1e-9).  (On
    the card the reverse rule is the VJP kernel, once differentiable.)"""
    x, y, ell = _inputs(17, 48, 36, 2)
    rng = np.random.default_rng(18)
    W = rng.normal(size=(48, 48 if same else 36))
    u = rng.normal(size=x.shape)
    jk, tk = KINDS[kind]

    def jloss(v, xx):
        k = v * st.with_lengthscale(jk(), jnp.asarray(ell))
        K = st.kernelmatrix(k, xx) if same else st.kernelmatrix(k, xx, jnp.asarray(y))
        return jnp.sum(jnp.asarray(W) * K)

    def jinner(v, xx):
        return jnp.vdot(jax.grad(jloss, argnums=1)(v, xx), jnp.asarray(u))

    jv, jx = jax.grad(jinner, argnums=(0, 1))(1.3, jnp.asarray(x))

    v = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    xx = torch.tensor(x, requires_grad=True)
    k = v * stt.with_lengthscale(tk(), torch.as_tensor(ell))
    K = stt.kernelmatrix(k, xx) if same else stt.kernelmatrix(k, xx, torch.as_tensor(y))
    (gx,) = torch.autograd.grad(torch.sum(torch.as_tensor(W) * K), xx, create_graph=True)
    tv, tx = torch.autograd.grad(torch.sum(gx * torch.as_tensor(u)), (v, xx))
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-9)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9, atol=1e-12 * np.abs(np.asarray(jx)).max())


def _psd(rng, n, dtype=np.float64):
    A = rng.normal(size=(n, n))
    return (A @ A.T + n * np.eye(n)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 128, 200, 256])
def test_plain_chol_block_matches_pallas_interpret(n, dtype):
    """The tiled plain version (32×32 tiles, identity padding) at ragged n,
    n < 32 and whole tiles, against the Pallas kernel in interpret mode and
    LAPACK."""
    K = _psd(np.random.default_rng(4), n, dtype)
    L_ref = np.linalg.cholesky(K)
    L_pallas = np.asarray(chol_block_auto(jnp.asarray(K)))
    # only tril(A) is read: garbage in the strict upper triangle is ignored
    A = torch.as_tensor(K + np.triu(np.full_like(K, 1e3), 1))
    L = tcb.chol_block(A).numpy()
    assert L.dtype == dtype and np.all(np.triu(L, 1) == 0)
    if dtype == np.float32:
        # tolerances of tests/test_ops.py:324-337
        np.testing.assert_allclose(L, L_ref, atol=2e-4 * np.abs(L_ref).max())
        np.testing.assert_allclose(L, L_pallas, atol=2e-4 * np.abs(L_ref).max())
    else:
        np.testing.assert_allclose(L, L_ref, rtol=1e-10, atol=1e-14 * np.abs(L_ref).max())
        np.testing.assert_allclose(L, L_pallas, rtol=1e-10, atol=1e-14 * np.abs(L_ref).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 128, 200, 256, 288])
def test_plain_tri_inv_block_matches_pallas_interpret(n, dtype):
    """The tiled plain version (32×32 tiles, identity padding, diagonal
    tiles first, then the right-looking tile sweep) at ragged n, n < 32,
    whole tiles and the kernels' limit 288, against the Pallas kernel in
    interpret mode and LAPACK's inverse."""
    L_ref = np.linalg.cholesky(_psd(np.random.default_rng(5), n)).astype(dtype)
    inv_ref = np.linalg.inv(L_ref.astype(np.float64))
    # only tril(L) is read: finite garbage in the strict upper triangle is
    # ignored, by the Pallas kernel too
    G = L_ref + np.triu(np.full_like(L_ref, 1e3), 1)
    M = tcb.tri_inv_block(torch.as_tensor(G)).numpy()
    M_pallas = np.asarray(tri_inv_block_auto(jnp.asarray(G)))
    assert M.dtype == dtype and np.all(np.triu(M, 1) == 0)
    scale = np.abs(inv_ref).max()
    if dtype == np.float32:
        np.testing.assert_allclose(M @ L_ref, np.eye(n), atol=5e-5)
        np.testing.assert_allclose(M, M_pallas, atol=5e-5 * scale)
        np.testing.assert_allclose(M, inv_ref, atol=5e-5 * scale)
    else:
        np.testing.assert_allclose(M, M_pallas, rtol=1e-10, atol=1e-14 * scale)
        np.testing.assert_allclose(M, inv_ref, rtol=1e-10, atol=1e-14 * scale)


@pytest.mark.parametrize("n,bad", [(4, 2), (40, 35), (70, 33)])
def test_tri_inv_block_zero_pivot_gives_inf_or_nan(n, bad):
    """A zero pivot gives inf (and NaN below it) and never raises, in the
    first diagonal tile or a later one; the rows before it are untouched."""
    L = torch.eye(n, dtype=torch.float64)
    L[bad, bad] = 0.0
    M = tcb.tri_inv_block(L)
    assert torch.isinf(M[bad, bad]) and not torch.isfinite(M[bad:, bad]).any()
    assert torch.all(M[:bad, :bad] == torch.eye(bad, dtype=torch.float64))


@pytest.mark.parametrize("n,bad", [(4, 2), (40, 35), (70, 33)])
def test_chol_block_nonpositive_pivot_gives_nan(n, bad):
    """A non-positive pivot gives NaN from rsqrt and never raises, in the
    first tile or a later one; the columns before it are untouched."""
    A = torch.eye(n, dtype=torch.float64)
    A[bad, bad] = -1.0
    L = tcb.chol_block(A)
    assert torch.isnan(L[bad, bad]) and torch.all(L[:bad, :bad] == torch.eye(bad, dtype=torch.float64))


def test_tri_inv_batched_dispatch():
    """A (4, 256, 256) stack inverts block by block, and the bottom-up
    batched `blocked_tri_inv_lower` (one kernel-3 call for the four base
    blocks, then GEMM combines) matches the reference's."""
    rng = np.random.default_rng(6)
    L_full = np.linalg.cholesky(_psd(rng, 1024))
    stack = np.stack([L_full[i * 256:(i + 1) * 256, i * 256:(i + 1) * 256] for i in range(4)])
    M = tcb.tri_inv_block(torch.as_tensor(stack)).numpy()
    for i in range(4):
        np.testing.assert_allclose(M[i], np.linalg.inv(stack[i]), rtol=1e-10, atol=1e-13)
    got = tbc.blocked_tri_inv_lower(torch.as_tensor(L_full), base=256).numpy()
    want = np.asarray(jbc.blocked_tri_inv_lower(jnp.asarray(L_full), base=256))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


def test_plain_versions_repeat_kernel_arithmetic_on_ragged_batches():
    rng = np.random.default_rng(7)
    A = np.stack([_psd(rng, 200) for _ in range(3)])
    L = tcb.chol_block(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=1e-10, atol=1e-12)
    for Li, Ai in zip(L, A):  # the batch, block by block, against the Pallas kernel
        np.testing.assert_allclose(Li, np.asarray(chol_block_auto(jnp.asarray(Ai))), rtol=1e-10, atol=1e-12)
    M = tcb.tri_inv_block(torch.as_tensor(L)).numpy()
    np.testing.assert_allclose(M, np.linalg.inv(L), rtol=1e-9, atol=1e-13)


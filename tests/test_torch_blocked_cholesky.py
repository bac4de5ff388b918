"""The port's blocked Cholesky, its reverse rule and the blocked solves
against `stheno_tpu.ops.blocked_cholesky`, in f64 on the CPU (where the
port's base cases are the library versions, as for any dtype but f32; f32
takes kernels 2 and 3, here their plain versions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu
import stheno_tpu_torch as stt
from stheno_tpu.ops import blocked_cholesky as jbc
from stheno_tpu_torch.ops import blocked_cholesky as tbc
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _psd(seed, n):
    A = np.random.default_rng(seed).normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


def _chol_fns(n, block, base):
    """The reference's and the port's factorisation; ragged n > block goes
    through the identity-padded entry point."""
    if n > block and n % block:
        return (lambda A: jbc.cholesky_blocked_padded(A, block, base),
                lambda A: tbc.cholesky_blocked_padded(A, block, base))
    return (lambda A: jbc.blocked_cholesky(A, block, base),
            lambda A: tbc.blocked_cholesky(A, block, base))


CASES = [
    (512, 1024, 256),   # default block/base (single 256-panel level)
    (512, 256, 128),    # small block/base
    (2048, 1024, 256),  # default: two 1024-panels, each recursing to 256
    (2048, 256, 128),
    (1536, 1024, 256),  # ragged: identity-padded to 2048
]


@pytest.mark.parametrize("n,block,base", CASES)
def test_blocked_cholesky_forward(n, block, base):
    K = _psd(0, n)
    jfn, tfn = _chol_fns(n, block, base)
    L_ref = np.asarray(jfn(jnp.asarray(K)))
    L = tfn(torch.as_tensor(K)).numpy()
    np.testing.assert_allclose(L, L_ref, rtol=1e-10, atol=1e-10 * np.abs(L_ref).max())
    # lower-triangle semantics: the strict upper triangle is never read
    K_junk = K + np.triu(np.full_like(K, 7.0), 1)
    np.testing.assert_array_equal(tfn(torch.as_tensor(K_junk)).numpy(), L)


@pytest.mark.parametrize("bwd_block", [512, 4096], ids=["iter", "rec"])
@pytest.mark.parametrize("n,block,base", CASES)
def test_blocked_cholesky_gradient(n, block, base, bwd_block):
    """Reverse rule under a random cotangent (the tests/test_ops.py:104
    pattern); bwd block 512 runs the panel sweep at these sizes, 4096 the
    recursive rule it falls back to."""
    K = _psd(1, n)
    ct = np.random.default_rng(2).normal(size=(n, n))
    jfn, tfn = _chol_fns(n, block, base)
    with stheno_tpu.config.bwd_params(block=bwd_block):
        _, vjp = jax.vjp(jfn, jnp.asarray(K))
        g_ref = np.asarray(vjp(jnp.asarray(ct))[0])
    A = torch.tensor(K, requires_grad=True)
    with stt.config.bwd_params(block=bwd_block):
        L = tfn(A)
    (g,) = torch.autograd.grad(L, A, torch.as_tensor(ct))
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-8, atol=1e-8 * np.abs(g_ref).max())
    np.testing.assert_allclose(g.numpy(), g.numpy().T, rtol=0, atol=1e-12 * np.abs(g_ref).max())


#: n -> block: 1536 > 1024 is ragged (identity-padded); 384 is no power-of-two
#: multiple of the inverse stack's base 256, so its stack is built block by block
SOLVE_BLOCKS = {512: 256, 1536: 1024, 768: 384}


@pytest.mark.parametrize("rhs", [(), (3,), (tbc._INV_MIN_COLS,)], ids=["vector", "matrix", "threshold"])
@pytest.mark.parametrize("n", list(SOLVE_BLOCKS))
@pytest.mark.parametrize("which", ["lower", "upper_T", "upper_T_via_inv"])
def test_blocked_solves_and_adjoints(which, n, rhs):
    """From `_INV_MIN_COLS` columns on the diagonal blocks are GEMMs
    against their inverses' stack (the adjoint reuses it), and narrower
    right-hand sides take TRSM; block 384 (no power-of-two multiple of 256)
    builds its stack block by block; `upper_T_via_inv` takes the stack
    whatever the width."""
    block = SOLVE_BLOCKS[n]
    L = np.linalg.cholesky(_psd(3, n))
    rng = np.random.default_rng(4)
    b = rng.normal(size=(n, *rhs))
    g = rng.normal(size=(n, *rhs))
    if which == "upper_T_via_inv":
        # the reverse sweep's fallback solve, diagonal blocks as GEMMs against
        # their inverses; it runs inside a backward, so it has no adjoint of
        # its own (the adjoint of the Lᵀ solve is the "upper_T" case's)
        x_ref = jbc.blocked_solve_upper_T(jnp.asarray(L), jnp.asarray(b), block, True)
        x, _ = tbc.blocked_solve(torch.as_tensor(L), torch.as_tensor(b), trans=True, block=block,
                                 via_inv=True)
        np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-10, atol=1e-13)
        return
    if which == "lower":
        jfn = lambda L_, b_: jbc.blocked_solve_lower(L_, b_, block)
        tfn = lambda L_, b_: tbc.blocked_solve_lower(L_, b_, block)
    else:
        jfn = lambda L_, b_: jbc.blocked_solve_upper_T(L_, b_, block)
        tfn = lambda L_, b_: tbc.blocked_solve_upper_T(L_, b_, block)
    x_ref, vjp = jax.vjp(jfn, jnp.asarray(L), jnp.asarray(b))
    gL_ref, gb_ref = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    Lt = torch.tensor(L, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    x = tfn(Lt, bt)
    gL, gb = torch.autograd.grad(x, (Lt, bt), torch.as_tensor(g))
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(x_ref), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(gb.numpy(), gb_ref, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(gL.numpy(), gL_ref, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("n,base", [(1024, 256), (768, 256), (2048, 512)])
def test_blocked_tri_inv_lower(n, base):
    """Batched bottom-up path (power-of-2 block counts) and the recursive
    split (768 = 3·256)."""
    L = np.linalg.cholesky(_psd(5, n))
    want = np.asarray(jbc.blocked_tri_inv_lower(jnp.asarray(L), base=base))
    got = tbc.blocked_tri_inv_lower(torch.as_tensor(L), base=base).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_inverse_stack_holds_each_diagonal_blocks_inverse(dtype):
    """`_diag_invs(L, B)`, one base-case call and batched combines (block
    by block where B is no power-of-two multiple of min(256, B)), then a
    Newton step, equals `blocked_tri_inv_lower` on each aligned diagonal
    B-block of a well-conditioned L (f32 takes kernel 3's plain version)."""
    L = torch.as_tensor(np.linalg.cholesky(_psd(15, 2048)), dtype=dtype)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    for n, B in [(2048, 128), (2048, 256), (2048, 512), (2048, 1024), (2048, 2048),
                 (1536, 384), (1536, 768)]:
        invs = tbc._diag_invs(L[:n, :n], B)
        assert invs.shape == (n // B, B, B)
        for k in range(n // B):
            want = tbc.blocked_tri_inv_lower(L[k * B : (k + 1) * B, k * B : (k + 1) * B], base=256)
            torch.testing.assert_close(invs[k], want, rtol=0, atol=tol * want.abs().max().item())


@pytest.mark.parametrize("jitter", [1e-3, 1e-4, 1e-5, 1e-6])
def test_stack_substitution_is_as_accurate_as_trsm_as_kappa_grows(jitter):
    """f32 at n = 2048, block 1024, on the factor of an SE Gram matrix of
    sorted points 16 to a length scale plus `jitter`·I (κ(L_kk) up to about
    10³): the forward and transposed substitutions against the stack come
    no further from float64 than `torch.linalg.solve_triangular` on the
    same f32 inputs (0.11–0.36× of it).  Without the stack's Newton step
    they read 2× to some hundreds of times it."""
    n, B = 2048, 1024
    x = np.sort(np.random.default_rng(21).uniform(0, n / 16, size=n))
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) + jitter * np.eye(n)
    L = torch.linalg.cholesky(torch.as_tensor(K)).float()
    b = torch.as_tensor(np.random.default_rng(22).normal(size=(n, 64)), dtype=torch.float32)
    invs = tbc._diag_invs(L, B)
    for trans in (False, True):
        want = torch.linalg.solve_triangular(L.double().mT if trans else L.double(), b.double(), upper=trans)
        library = torch.linalg.solve_triangular(L.mT if trans else L, b, upper=trans)
        got, _ = tbc.blocked_solve(L, b, trans, invs, B)
        err, err_lib = ((torch.linalg.norm(v.double() - want) / torch.linalg.norm(want)).item()
                        for v in (got, library))
        assert err <= err_lib, (trans, err, err_lib)


@pytest.mark.parametrize("which", ["lower", "upper_T"])
def test_second_derivatives_through_wide_blocked_solves(which):
    """f64, n = 512, block 256, a 3-column right-hand side: `gradgradcheck`
    through L, along two directions of a lower-triangular perturbation.  A
    reverse rule that autograd records solves by one TRSM on the whole of L,
    since the blocked loop writes in place and the forward's stack of
    diagonal-block inverses has no graph."""
    n = 512
    rng = np.random.default_rng(23)
    L0 = torch.as_tensor(np.linalg.cholesky(_psd(3, n)))
    E = torch.as_tensor(np.tril(rng.normal(size=(2, n, n))))
    W = torch.as_tensor(rng.normal(size=(n, 3)))
    solve = tbc.blocked_solve_lower if which == "lower" else tbc.blocked_solve_upper_T

    b = torch.as_tensor(rng.normal(size=(n, 3)))

    def f(theta):
        L = L0 + theta[0] * E[0] + theta[1] * E[1]
        return (solve(L, b, 256) * W).sum(0)

    theta = torch.zeros(2, dtype=torch.float64, requires_grad=True)
    with stt.config.chol_backend("blocked"):
        assert torch.autograd.gradgradcheck(f, (theta,), atol=1e-6, rtol=1e-5)


def test_blocked_cholesky_nonsquare_panel_fallback():
    """n not divisible by the panel width falls back to torch.linalg on
    tril(A), as the reference falls back to lax."""
    n = 320  # panel width B = 128 does not divide 320
    K = _psd(6, n)
    L_ref = np.asarray(jbc.blocked_cholesky(jnp.asarray(K), 256, 64))
    L = tbc.blocked_cholesky(torch.as_tensor(K), 256, 64).numpy()
    np.testing.assert_allclose(L, L_ref, rtol=1e-10, atol=1e-10 * np.abs(L_ref).max())


@pytest.mark.parametrize("bwd_block", [128, 256])
@pytest.mark.parametrize("via_inv", [True, False], ids=["via_inv", "trsm"])
@pytest.mark.parametrize("mode", ["iter", "rec", "fused"])
def test_gradient_of_each_backward_mode(mode, via_inv, bwd_block):
    """Every reverse rule against the reference's under the same
    `bwd_params`, at N = 512, block 128, base 64.  Backward block 128 lines
    the sweeps up with the forward's panels (the fused sweep reuses the
    saved inverses), 256 does not (it rebuilds them)."""
    n, block, base = 512, 128, 64
    K = _psd(7, n)
    ct = np.random.default_rng(8).normal(size=(n, n))
    params = dict(base=base, via_inv=via_inv, mode=mode, block=bwd_block)
    with stheno_tpu.config.bwd_params(**params):
        _, vjp = jax.vjp(lambda A: jbc.blocked_cholesky(A, block, base), jnp.asarray(K))
        g_ref = np.asarray(vjp(jnp.asarray(ct))[0])
    A = torch.tensor(K, requires_grad=True)
    with stt.config.bwd_params(**params):
        L = tbc.blocked_cholesky(A, block, base)
    (g,) = torch.autograd.grad(L, A, torch.as_tensor(ct))
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-8, atol=1e-8 * np.abs(g_ref).max())


@pytest.mark.parametrize("n,block,base", [(512, 128, 64), (640, 256, 64)], ids=["aligned", "ragged"])
def test_sym_fold_value_and_gradient(n, block, base):
    """`sym=True` factors 0.5·(A + Aᵀ) of a non-symmetric A; its gradient is
    the symmetric pullback.  The ragged case goes through the padded entry
    point."""
    A_np = _psd(9, n) + np.random.default_rng(10).normal(size=(n, n))
    ct = np.random.default_rng(11).normal(size=(n, n))
    L_ref, vjp = jax.vjp(lambda A: jbc.cholesky_blocked_padded(A, block, base, True), jnp.asarray(A_np))
    g_ref = np.asarray(vjp(jnp.asarray(ct))[0])
    A = torch.tensor(A_np, requires_grad=True)
    L = tbc.cholesky_blocked_padded(A, block, base, sym=True)
    (g,) = torch.autograd.grad(L, A, torch.as_tensor(ct))
    L_ref = np.asarray(L_ref)
    np.testing.assert_allclose(L.detach().numpy(), L_ref, rtol=1e-10, atol=1e-10 * np.abs(L_ref).max())
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-8, atol=1e-8 * np.abs(g_ref).max())
    # the fold is the factor of the symmetrised matrix
    L_sym = tbc.cholesky_blocked_padded(torch.as_tensor(0.5 * (A_np + A_np.T)), block, base)
    np.testing.assert_allclose(L.detach().numpy(), L_sym.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,block", [(512, 128), (512, 512), (500, 128)], ids=["panels", "one", "ragged"])
def test_blocked_lauum(n, block):
    M = np.linalg.cholesky(_psd(12, n))
    want = np.asarray(jbc.blocked_lauum(jnp.asarray(M), block))
    got = tbc.blocked_lauum(torch.as_tensor(M), block).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(got, M.T @ M, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_base_overrides_are_honoured_and_do_not_leak():
    """The scoped `base_cholesky` and `base_tri_inv` replace kernels 2 and 3
    (here their plain versions) in the forward and in the backward run
    after the scope closed, and nothing of them survives the scope, even
    one left by an exception."""
    calls = {"chol": 0, "inv": 0}

    def spy_chol(A):
        calls["chol"] += 1
        return tbc.torch_chol_lower(A)

    def spy_inv(L):
        calls["inv"] += 1
        return tbc.torch_tri_inv_lower(L)

    n, block, base = 512, 128, 64
    K = _psd(13, n)
    L_default = tbc.blocked_cholesky(torch.as_tensor(K), block, base)
    A = torch.tensor(K, requires_grad=True)
    with stt.config.scoped(base_cholesky=spy_chol, base_tri_inv=spy_inv), \
            stt.config.bwd_params(mode="fused", block=256):
        L = tbc.blocked_cholesky(A, block, base)
    fwd_calls = dict(calls)
    assert fwd_calls["chol"] > 0 and fwd_calls["inv"] > 0
    torch.autograd.grad(L, A, torch.ones_like(L))
    assert calls["inv"] > fwd_calls["inv"]  # the fused sweep rebuilt its inverses with it
    np.testing.assert_allclose(L.detach().numpy(), L_default.numpy(), rtol=1e-12, atol=1e-12)
    with pytest.raises(ZeroDivisionError):
        with stt.config.scoped(base_cholesky=spy_chol, base_tri_inv=spy_inv):
            1 / 0
    before = dict(calls)
    tbc.blocked_cholesky(torch.as_tensor(K), block, base)
    assert calls == before
    assert stt.config.active_override("base_cholesky", None) is None
    assert stt.config.active_override("base_tri_inv", None) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_base_cases_are_chosen_by_dtype(dtype, monkeypatch):
    """f32 blocks go to kernels 2 and 3; any other dtype to the library
    versions, chosen before any launch (the kernels take f32 only)."""
    calls = []
    for name in ("chol_block", "tri_inv_block", "torch_chol_lower", "torch_tri_inv_lower"):
        fn = getattr(tbc, name)
        monkeypatch.setattr(tbc, name, lambda A, fn=fn, name=name: calls.append(name) or fn(A))
    K = torch.as_tensor(_psd(14, 512), dtype=dtype)
    L = tbc.blocked_cholesky(K, 256, 128)
    want = {"chol_block", "tri_inv_block"} if dtype == torch.float32 else {
        "torch_chol_lower", "torch_tri_inv_lower"}
    assert set(calls) == want
    assert tbc.default_bases(dtype) == (getattr(tbc, sorted(want)[0]), getattr(tbc, sorted(want)[1]))
    np.testing.assert_allclose(L.double().numpy(), np.linalg.cholesky(K.double().numpy()),
                               rtol=0, atol=1e-4 if dtype == torch.float32 else 1e-10)

"""The port's state-space tier (`stheno_tpu_torch.markov`) against
`stheno_tpu.markov` on the same numpy-seeded inputs, in f64 on the CPU
unless a case says otherwise, and the port's associative scan against a
sequential fold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as st
import stheno_tpu_torch as stt
from stheno_tpu import markov as jm
from stheno_tpu_torch import markov as tm
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _kernel_pair(name):
    """The same kernel in both packages (tests/test_markov.py:26-33)."""
    if name == "m12":
        return st.Matern12Kernel(), stt.Matern12Kernel()
    if name == "m32":
        return st.Matern32Kernel(), stt.Matern32Kernel()
    if name == "m52":
        return st.Matern52Kernel(), stt.Matern52Kernel()
    if name == "scaled":
        return (2.3 * st.with_lengthscale(st.Matern32Kernel(), 0.7),
                2.3 * stt.with_lengthscale(stt.Matern32Kernel(), 0.7))
    return (1.5 * st.with_lengthscale(st.Matern52Kernel(), 1.2) + 0.4 * st.Matern12Kernel(),
            1.5 * stt.with_lengthscale(stt.Matern52Kernel(), 1.2) + 0.4 * stt.Matern12Kernel())


KERNELS = ["m12", "m32", "m52", "scaled", "sum"]


def _data(seed, n, lo=-3.0, hi=3.0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(lo, hi, n))
    y = np.sin(2.0 * x) + 0.3 * rng.normal(size=n)
    return x, y


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("parallel", [False, True], ids=["seq", "par"])
@pytest.mark.parametrize("name", KERNELS)
def test_logpdf_matches_reference(name, parallel):
    jk, tk = _kernel_pair(name)
    x, y = _data(0, 201)
    want = float(jax.jit(lambda xx, yy: jm.markov_gp_logpdf(jk, xx, yy, 0.1, parallel=parallel))(
        jnp.asarray(x), jnp.asarray(y)))
    got = tm.markov_gp_logpdf(tk, _t(x), _t(y), 0.1, parallel=parallel).item()
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("name", ["m32", "sum"])
def test_hyperparameter_gradient_matches_jax(name):
    x, y = _data(5, 150)

    def j_lp(th):
        k = jnp.exp(th[0]) * st.with_lengthscale(st.Matern32Kernel(), jnp.exp(th[1]))
        if name == "sum":
            k = k + jnp.exp(th[2]) * st.Matern12Kernel()
        return jm.markov_gp_logpdf(k, jnp.asarray(x), jnp.asarray(y), 0.05)

    th0 = np.asarray([0.3, -0.2, -0.9])
    want = np.asarray(jax.jit(jax.grad(j_lp))(jnp.asarray(th0)))
    th = torch.tensor(th0, requires_grad=True)
    k = torch.exp(th[0]) * stt.with_lengthscale(stt.Matern32Kernel(), torch.exp(th[1]))
    if name == "sum":
        k = k + torch.exp(th[2]) * stt.Matern12Kernel()
    (got,) = torch.autograd.grad(tm.markov_gp_logpdf(k, _t(x), _t(y), 0.05), th)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("parallel", [False, True], ids=["seq", "par"])
@pytest.mark.parametrize("at", ["x", "x_star"])
def test_posterior_marginals_match_reference(at, parallel):
    jk, tk = _kernel_pair("scaled")
    x, y = _data(2, 180)
    xs = np.linspace(-3.5, 3.5, 97) if at == "x_star" else None
    mj, vj = jax.jit(lambda xx, yy, ss: jm.markov_gp_posterior_marginals(
        jk, xx, yy, 0.05, x_star=ss, parallel=parallel))(
        jnp.asarray(x), jnp.asarray(y), None if xs is None else jnp.asarray(xs))
    mt, vt = tm.markov_gp_posterior_marginals(
        tk, _t(x), _t(y), 0.05, x_star=None if xs is None else _t(xs), parallel=parallel)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-10)


def test_per_point_noise():
    jk, tk = _kernel_pair("m32")
    x, y = _data(4, 90)
    noise = np.random.default_rng(4).uniform(0.05, 0.4, 90)
    want = float(jax.jit(lambda xx, yy, nn: jm.markov_gp_logpdf(jk, xx, yy, nn))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise)))
    got = tm.markov_gp_logpdf(tk, _t(x), _t(y), _t(noise)).item()
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_parallel_smoother_matches_sequential():
    _, tk = _kernel_pair("sum")
    x, y = _data(7, 257)
    A, Q, H, ya, r, _ = tm._prep(tk, _t(x), _t(y), 0.1, None)
    mask = torch.ones(ya.shape, dtype=torch.bool)
    m_f, P_f = tm._parallel_filter(A, Q, H, ya, r, mask)
    ms1, Ps1 = tm._rts_smoother(A, Q, m_f, P_f)
    ms2, Ps2 = tm._parallel_smoother(A, Q, m_f, P_f)
    np.testing.assert_allclose(ms2.numpy(), ms1.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Ps2.numpy(), Ps1.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", KERNELS)
def test_stationary_first_step(name):
    """A single observation's logpdf is log N(y; 0, k(0, 0) + noise)."""
    jk, tk = _kernel_pair(name)
    var = float(jk.diag_same(jnp.asarray([0.0]))[0])
    y0, noise = 0.37, 0.2
    got = tm.markov_gp_logpdf(tk, _t([1.3]), _t([y0]), noise).item()
    s = var + noise
    np.testing.assert_allclose(got, -0.5 * (np.log(2 * np.pi * s) + y0**2 / s), rtol=1e-12)


def test_f32_is_close_to_f64():
    _, tk = _kernel_pair("m52")
    x, y = _data(6, 400)
    lp64 = tm.markov_gp_logpdf(tk, _t(x), _t(y), 0.1).item()
    lp32 = tm.markov_gp_logpdf(tk, _t(x).float(), _t(y).float(), np.float32(0.1),
                               dtype=torch.float32)
    assert lp32.dtype == torch.float32 and np.isfinite(lp32.item())
    assert abs(lp32.item() - lp64) < 5e-3 * abs(lp64)


def test_f32_gradient_at_dense_inputs():
    """The probe's data at N = 5·10⁴ (gaps of 0.08 against a lengthscale
    of 5): with Q from Van Loan's block exponential the f32 gradient stays
    within 5e-6 of f64 (measured 4.7e-7 on the CPU); the reference's
    P∞ − A P∞ Aᵀ measured 2.9e-5 here, and 3.5e-2 at N = 10⁶ on an H100."""
    from stheno_tpu_torch.perf_probe import markov_inputs, markov_kernel

    x, y = markov_inputs(50_000, torch.float32, "cpu")

    def value_and_grad(dtype):
        lv = torch.tensor([1.2, 5.0], dtype=dtype, requires_grad=True)
        v = tm.markov_gp_logpdf(markov_kernel(lv), x.to(dtype), y.to(dtype), 0.1, dtype=dtype)
        return v.item(), torch.autograd.grad(v, lv)[0].numpy()

    v32, g32 = value_and_grad(torch.float32)
    v64, g64 = value_and_grad(torch.float64)
    assert abs(v32 - v64) <= 1e-6 * abs(v64)
    np.testing.assert_allclose(g32, g64, rtol=5e-6)


def _qerr(Q, Q64):
    """max |Q − Q64| relative to √(Q64_ii Q64_jj), over the batch."""
    dg = Q64.diagonal(dim1=1, dim2=2)
    return ((Q.double() - Q64).abs() / (dg[:, :, None] * dg[:, None, :]).sqrt()).max().item()


@pytest.mark.parametrize("name", ["m12", "m32", "m52"])
def test_transition_f32_over_all_gaps(name):
    """Q in f32 against f64 from ‖F‖₁Δ = 0.5 to 10⁴: the block exponential
    serves the short gaps, the subtraction the long ones (measured ≤ 3.4e-5
    on the CPU, at 4 for Matérn-5/2); the block exponential alone gives inf
    or NaN beyond about 100 and loses whole entries of Q there first."""
    [(F, _, P)] = tm._sde_blocks(_kernel_pair(name)[1], torch.float64, "cpu")
    d = torch.logspace(-0.3, 4.0, 44, dtype=torch.float64) / torch.linalg.matrix_norm(F, 1)
    A64, Q64 = tm._transition(F, P, d)
    A32, Q32 = tm._transition(F.float(), P.float(), d.float())
    assert bool(torch.isfinite(A32).all() and torch.isfinite(Q32).all())
    assert _qerr(Q32, Q64) <= 1e-4
    # where the subtraction serves, it is the reference's formula exactly
    long = d * torch.linalg.matrix_norm(F, 1) > tm.VAN_LOAN_MAX
    np.testing.assert_allclose(Q64[long].numpy(), (P - A64 @ P @ A64.mT)[long].numpy(), rtol=0, atol=1e-15)


def _gappy_data(seed, clusters=6, per=12):
    """Clusters of `per` points over 2 lengthscales, 100–1000 lengthscales
    apart (a time series with long gaps)."""
    rng = np.random.default_rng(seed)
    starts = np.cumsum(rng.uniform(100.0, 1000.0, clusters))
    x = np.concatenate([s + np.sort(rng.uniform(0.0, 2.0, per)) for s in starts])
    y = np.sin(2.0 * x) + 0.3 * rng.normal(size=x.size)
    # rounded to f32, so that both precisions see the same inputs
    return x.astype(np.float32).astype(np.float64), y.astype(np.float32).astype(np.float64)


#: the f32 port against the f64 reference on `_gappy_data`: logpdf, its
#: gradient and the marginals (measured on the CPU: 2.3e-7 and 6.8e-5
#: relative, 4.4e-7 absolute; the reference in f32 gives 1.5e-7 and 8.1e-5)
GAPPY_F32_VAL_RTOL, GAPPY_F32_GRAD_RTOL, GAPPY_F32_ATOL = 1e-6, 5e-4, 5e-6


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("parallel", [False, True], ids=["seq", "par"])
def test_long_gaps_logpdf_and_gradient_match_reference(parallel, dtype):
    """Gaps of 100–1000 lengthscales, where the block exponential alone
    overflows: value and hyperparameter gradient against the reference in
    f64 (its P∞ − A P∞ Aᵀ is exact there)."""
    x, y = _gappy_data(11)

    def j_lp(th):
        k = jnp.exp(th[0]) * st.with_lengthscale(st.Matern52Kernel(), jnp.exp(th[1]))
        k = k + jnp.exp(th[2]) * st.Matern32Kernel()
        return jm.markov_gp_logpdf(k, jnp.asarray(x), jnp.asarray(y), 0.05, parallel=parallel)

    th0 = np.asarray([0.3, 0.2, -0.9])
    want = float(jax.jit(j_lp)(jnp.asarray(th0)))
    want_g = np.asarray(jax.jit(jax.grad(j_lp))(jnp.asarray(th0)))
    th = torch.tensor(th0, dtype=dtype, requires_grad=True)
    k = torch.exp(th[0]) * stt.with_lengthscale(stt.Matern52Kernel(), torch.exp(th[1]))
    k = k + torch.exp(th[2]) * stt.Matern32Kernel()
    got = tm.markov_gp_logpdf(k, _t(x).to(dtype), _t(y).to(dtype), 0.05, parallel=parallel, dtype=dtype)
    (got_g,) = torch.autograd.grad(got, th)
    assert got.dtype == dtype and bool(torch.isfinite(got_g).all())
    f64 = dtype == torch.float64
    np.testing.assert_allclose(got.item(), want, rtol=1e-10 if f64 else GAPPY_F32_VAL_RTOL)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-8 if f64 else GAPPY_F32_GRAD_RTOL, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("at", ["x", "x_star"])
def test_long_gaps_posterior_marginals_match_reference(at, dtype):
    """The same gaps, and x_star far outside the data on both sides."""
    jk, tk = _kernel_pair("sum")
    x, y = _gappy_data(12)
    xs = None
    if at == "x_star":
        mid = 0.5 * (x[11::12][:-1] + x[12::12])  # halfway across each gap
        xs = np.sort(np.concatenate([[x[0] - 700.0, x[-1] + 900.0], x[:5] + 0.01, mid]))
        xs = xs.astype(np.float32).astype(np.float64)
    mj, vj = jax.jit(lambda xx, yy, ss: jm.markov_gp_posterior_marginals(jk, xx, yy, 0.05, x_star=ss))(
        jnp.asarray(x), jnp.asarray(y), None if xs is None else jnp.asarray(xs))
    mt, vt = tm.markov_gp_posterior_marginals(
        tk, _t(x).to(dtype), _t(y).to(dtype), 0.05, x_star=None if xs is None else _t(xs).to(dtype),
        dtype=dtype)
    atol = 1e-10 if dtype == torch.float64 else GAPPY_F32_ATOL
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=atol)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=atol)


def test_non_markov_kernels_raise():
    for k in [stt.SEKernel(), stt.Matern32Kernel() * stt.Matern12Kernel(),
              stt.with_lengthscale(stt.Matern32Kernel(), torch.tensor([1.0, 2.0]))]:
        with pytest.raises(TypeError):
            tm.sde_representation(k, device="cpu")


def test_unsorted_inputs_raise():
    """The reference silently returns a wrong value here (ROADMAP §C)."""
    _, tk = _kernel_pair("m32")
    x, y = _data(8, 50)
    x[[10, 11]] = x[[11, 10]]
    with pytest.raises(ValueError, match="sorted"):
        tm.markov_gp_logpdf(tk, _t(x), _t(y), 0.1)
    with pytest.raises(ValueError, match="sorted"):
        tm.markov_gp_posterior_marginals(tk, _t(x), _t(y), 0.1)


def test_per_point_noise_with_x_star_raises():
    """The reference fails here with a shape error (ROADMAP §C)."""
    _, tk = _kernel_pair("m32")
    x, y = _data(9, 50)
    with pytest.raises(ValueError, match="per-point noise"):
        tm.markov_gp_posterior_marginals(tk, _t(x), _t(y), _t(np.full(50, 0.1)),
                                         x_star=_t(np.linspace(-1, 1, 5)))


def test_inputs_that_are_not_tensors_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tk = _kernel_pair("m32")
    x, y = _data(10, 20)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.markov_gp_logpdf(tk, x, y, 0.1)
    assert np.isfinite(tm.markov_gp_logpdf(tk, x, y, 0.1, device="cpu").item())


def _sequential_fold(op, M, reverse):
    out = [None] * M.shape[0]
    acc = None
    for k in (reversed(range(M.shape[0])) if reverse else range(M.shape[0])):
        acc = M[k] if acc is None else op((acc,), (M[k],))[0]
        out[k] = acc
    return torch.stack(out)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 1000])
def test_associative_scan_matches_sequential_fold(n, reverse):
    """Products of random orthogonal 2×2 matrices (rotations and
    reflections, which do not commute; bounded, so errors cannot grow)."""
    M = _t(np.linalg.qr(np.random.default_rng(n).normal(size=(n, 2, 2)))[0])
    op = lambda a, b: (b[0] @ a[0],)
    (got,) = tm.associative_scan(op, (M,), reverse=reverse)
    np.testing.assert_allclose(got.numpy(), _sequential_fold(op, M, reverse).numpy(),
                               rtol=0, atol=1e-13)
    (ref,) = jax.jit(lambda m: jax.lax.associative_scan(
        lambda a, b: (b[0] @ a[0],), (m,), reverse=reverse))(jnp.asarray(M.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-13)

"""`rand` and `mvn_sample_chol` of the port, on the CPU in f64 (f32 on the
blocked path).  Samples cannot match the reference's bit for bit, so they
are held statistically: the sample mean and covariance of S = 20000 draws
against `fx.mean()` and `fx.cov()` (which the other test files hold against
`stheno_tpu`), and whitened samples L⁻¹(y − m), with L from numpy's
Cholesky of the same covariance, against N(0, 1), for a `FiniteGP`, a
`PosteriorGP` and a `BlockData` query.  Every statistical bound is 5σ of
its estimator."""

import numpy as np
import pytest
import torch

import stheno_tpu as st
import stheno_tpu_torch as stt
from stheno_tpu_torch.ops import chol as tchol
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _programme():
    @stt.gppp
    def build():
        f1 = stt.GP(stt.SEKernel())
        f2 = stt.GP(0.5 * stt.with_lengthscale(stt.Matern52Kernel(), 0.3))
        return dict(f1=f1, f2=f2, f3=f1 + f2 + 0.7)

    return build()


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _x(seed, n):
    return torch.as_tensor(np.sort(np.random.default_rng(seed).uniform(-2, 2, n)))


def _assert_standard_normal(z):
    """z (any shape) against iid N(0, 1): its mean and its variance each
    within 5σ of their estimators."""
    z = np.asarray(z, dtype=np.float64).ravel()
    n = z.size
    assert np.all(np.isfinite(z))
    assert abs(z.mean()) <= 5.0 / np.sqrt(n), z.mean()
    assert abs(z.var() - 1.0) <= 5.0 * np.sqrt(2.0 / n), z.var()


def _whiten(fx, ys):
    """L⁻¹(y − m) with L numpy's Cholesky of fx.cov() in f64."""
    K = fx.cov().detach().double().numpy()
    L = np.linalg.cholesky(0.5 * (K + K.T))
    m = fx.mean().detach().double().numpy()
    return np.linalg.solve(L, ys.detach().double().numpy() - m[:, None])


def test_sample_mean_and_covariance_match_the_moments():
    f = _programme()
    fx = f(stt.GPPPInput("f3", _x(0, 6)), 0.05)
    S = 20000
    ys = stt.rand(_gen(1), fx, S).numpy()
    m, K = fx.mean().numpy(), fx.cov().numpy()
    d = np.diag(K)
    assert np.all(np.abs(ys.mean(1) - m) <= 5.0 * np.sqrt(d / S))
    C = np.cov(ys)
    sd = np.sqrt((np.outer(d, d) + K**2) / S)  # std of each sample covariance
    assert np.all(np.abs(C - K) <= 5.0 * sd)


@pytest.mark.parametrize("case", ["finite_gp", "posterior", "blockdata"])
def test_whitened_samples_are_standard_normal(case):
    f = _programme()
    x = _x(2, 40)
    if case == "finite_gp":
        fx = f(stt.GPPPInput("f3", x), 0.05)
    elif case == "posterior":
        y = torch.sin(3.0 * x)
        post = stt.posterior(f(stt.GPPPInput("f3", x), 0.05), y)
        fx = post(stt.GPPPInput("f1", _x(3, 30)), 1e-4)
    else:
        fx = f(stt.BlockData(stt.GPPPInput("f1", x[:15]), stt.GPPPInput("f3", x[15:]),
                             stt.GPPPInput("f2", _x(4, 10))), 1e-3)
    ys = stt.rand(_gen(5), fx, 500)
    assert ys.shape == (len(fx), 500)
    _assert_standard_normal(_whiten(fx, ys))


def test_blocked_backend_samples():
    """f32 at N = 1024 under the blocked backend: panels of 512 down to the
    256-blocks of kernels 2 and 3's plain versions."""
    f = _programme()
    fx = f(stt.GPPPInput("f3", torch.linspace(-3, 3, 1024)), 0.1)
    with stt.config.chol_backend("blocked"):
        ys = stt.rand(_gen(6), fx, 64)
    assert ys.dtype == torch.float32 and ys.shape == (1024, 64)
    _assert_standard_normal(_whiten(fx, ys))


def test_shapes_and_reproducibility():
    f = _programme()
    fx = f(stt.GPPPInput("f3", _x(7, 9)), 0.1)
    y = stt.rand(_gen(8), fx)
    assert y.shape == (9,) and y.dtype == torch.float64
    assert stt.rand(_gen(8), fx, 3).shape == (9, 3)
    torch.testing.assert_close(stt.rand(_gen(8), fx), y, rtol=0, atol=0)
    assert not torch.equal(stt.rand(_gen(9), fx), y)
    g = _gen(10)
    a, b = stt.rand(g, fx, 2), stt.rand(g, fx, 2)  # one generator moves on
    assert not torch.equal(a, b)
    # the reference's shapes for the same query
    jfx = st.GP(st.SEKernel(), gpc=st.GPC())(np.zeros(9), 0.1)
    import jax

    assert st.rand(jax.random.PRNGKey(0), jfx).shape == y.shape
    assert st.rand(jax.random.PRNGKey(0), jfx, 3).shape == (9, 3)


def test_mvn_sample_chol_shapes_and_moments():
    L = torch.linalg.cholesky(torch.tensor([[2.0, 0.3], [0.3, 0.5]], dtype=torch.float64))
    mean = torch.tensor([1.0, -2.0], dtype=torch.float64)
    s = tchol.mvn_sample_chol(_gen(11), mean, L)
    assert s.shape == (2,)
    ss = tchol.mvn_sample_chol(_gen(12), mean, L, (4, 20000))
    assert ss.shape == (4, 20000, 2)
    z = torch.linalg.solve_triangular(L, (ss - mean).reshape(-1, 2).T, upper=False)
    _assert_standard_normal(z.numpy())

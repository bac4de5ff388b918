"""The port's plain ops against `stheno_tpu.ops`, in f64 on the CPU:
pairwise distances with their gradients (the safe gradient at zero
distance included) and the small-N Cholesky, solves and MvNormal logpdf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stheno_tpu import ops as jops
from stheno_tpu.ops import chol as jchol
from stheno_tpu_torch import ops as tops
from stheno_tpu_torch.ops import chol as tchol
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


ZERO = (5, 3)  # the pair (x_5, y_3) is at distance exactly 0


def _points(dim, seed=0):
    rng = np.random.default_rng(seed)
    shape = lambda k: (k, dim) if dim > 1 else (k,)
    x = rng.normal(size=shape(12))
    y = rng.normal(size=shape(9))
    y[ZERO[1]] = x[ZERO[0]]
    return x, y


@pytest.mark.parametrize("dim", [1, 3])
@pytest.mark.parametrize("name", ["pairwise_sqdist", "pairwise_dist", "pairwise_dot"])
def test_pairwise_values_and_gradients_match_reference(name, dim):
    x, y = _points(dim)
    W = np.random.default_rng(1).normal(size=(12, 9))
    if name == "pairwise_dist" and dim == 1:
        # the reference's D=1 path takes jnp.abs, whose gradient at 0 is 1,
        # though its comment (and its D>1 masked sqrt) give 0; the port gives
        # 0 (test_pairwise_dist_gradient_is_zero_at_zero_distance), so the
        # comparison leaves that one pair out
        W[ZERO] = 0.0
    jfn, tfn = getattr(jops, name), getattr(tops, name)
    np.testing.assert_allclose(tfn(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
                               np.asarray(jfn(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-12, atol=1e-14)
    jg = jax.grad(lambda a, b: jnp.sum(jnp.asarray(W) * jfn(a, b)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    tg = torch.autograd.grad(torch.sum(torch.as_tensor(W) * tfn(xt, yt)), (xt, yt))
    # D=3 distances go through the matmul identity, whose value at the
    # duplicate pair is f64 rounding noise in each library: an absolute 1e-8
    for a, b in zip(tg, jg):
        assert np.all(np.isfinite(a.numpy()))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-8 if dim > 1 else 1e-12)


@pytest.mark.parametrize("dim", [1, 3])
def test_pairwise_dist_gradient_is_zero_at_zero_distance(dim):
    x, y = _points(dim)
    W = np.zeros((12, 9))
    W[ZERO] = 1.0
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    gx, gy = torch.autograd.grad(torch.sum(torch.as_tensor(W) * tops.pairwise_dist(xt, yt)), (xt, yt))
    assert not gx.any() and not gy.any()


@pytest.mark.parametrize("dim", [1, 3])
@pytest.mark.parametrize("name", ["sqdist_diag", "dist_diag", "dot_diag"])
def test_diag_forms_match_reference(name, dim):
    x, _ = _points(dim)
    y = x.copy()
    y[1:] += 0.3  # y_0 = x_0: the zero-distance entry
    got = getattr(tops.pairwise, name)(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    want = np.asarray(getattr(jops.pairwise, name)(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def _spd(n, seed=2):
    A = np.random.default_rng(seed).normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


def test_cholesky_psd_symmetrises_on_the_library_route():
    K = _spd(40)
    K_skew = K + np.triu(np.full_like(K, 1e-3), 1)  # asymmetric noise
    for jitter in (None, 0.5):
        got = tops.cholesky_psd(torch.as_tensor(K_skew), jitter=jitter).numpy()
        want = np.asarray(jchol.cholesky_psd(jnp.asarray(K_skew), jitter=jitter))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # a matrix that is not positive definite gives NaN and does not raise
    assert torch.isnan(tops.cholesky_psd(-torch.eye(3, dtype=torch.float64))).all()


@pytest.mark.parametrize("rhs", [(), (4,)], ids=["vector", "matrix"])
def test_solves_logdet_and_logpdf_match_reference(rhs):
    n = 30
    L = np.linalg.cholesky(_spd(n))
    rng = np.random.default_rng(3)
    b = rng.normal(size=(n, *rhs))
    mean = rng.normal(size=n)
    Lt, bt, Lj, bj = torch.as_tensor(L), torch.as_tensor(b), jnp.asarray(L), jnp.asarray(b)
    cases = [
        (tops.solve_lower(Lt, bt), jchol.solve_lower(Lj, bj)),
        (tops.solve_lower(Lt, bt, trans=True), jchol.solve_lower(Lj, bj, trans=True)),
        (tops.solve_upper(Lt.T.contiguous(), bt), jchol.solve_upper(Lj.T, bj)),
        (tops.solve_upper(Lt.T.contiguous(), bt, trans=True), jchol.solve_upper(Lj.T, bj, trans=True)),
        (tops.chol_solve(Lt, bt), jchol.chol_solve(Lj, bj)),
        (tops.chol_logdet(Lt), jchol.chol_logdet(Lj)),
        (tops.mvn_logpdf_chol(bt, torch.as_tensor(mean), Lt),
         jchol.mvn_logpdf_chol(bj, jnp.asarray(mean), Lj)),
        (tops.mvn_logpdf_psd(bt, torch.as_tensor(mean), torch.as_tensor(L @ L.T)),
         jchol.mvn_logpdf_psd(bj, jnp.asarray(mean), jnp.asarray(L @ L.T))),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_blocked_route_is_taken_only_where_it_should_be():
    K = torch.eye(8, dtype=torch.float64)
    assert not tchol._use_blocked(K)  # CPU tensor under 'auto'
    with tchol._cfg.chol_backend("blocked"):
        assert tchol._use_blocked(K) and not tchol._use_blocked(K[None])
    with tchol._cfg.chol_backend("torch"):
        assert not tchol._use_blocked(K)

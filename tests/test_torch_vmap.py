"""The GP log-density under `torch.func.vmap(torch.func.grad_and_value(·))`,
the samplers' batched evaluation: against JAX's `vmap(value_and_grad)` on
the same θ batch (rtol 1e-10 in f64), against a loop over chains in the
port (rtol 1e-12: the same arithmetic per chain), for the NUTS example's
model and the SMC example's SE and Matern32 models; kernel 1's batched
plain version against the unbatched one per entry (exact), and its `vmap`
rules (one batched forward and one batched VJP per evaluation); and the
Cholesky routing, which never sends a vmapped covariance to the blocked
path, under any backend."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as st
import stheno_tpu_torch as stt
from stheno_tpu import params as JP
from stheno_tpu_torch import entry as E
from stheno_tpu_torch.cuda import kernelmatrix as tkm
from stheno_tpu_torch.func_transforms import is_vmapped
from stheno_tpu_torch.ops import blocked_cholesky as tbc
from stheno_tpu_torch.ops import chol as tchol
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _thetas(theta0, chains=6, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(theta0)[None, :] + 0.5 * rng.normal(size=(chains, len(theta0)))


def _jax_nuts_logdensity(x, y):
    @st.gppp
    def build(p):
        return dict(f=st.GP(p["v"] * st.with_lengthscale(st.SEKernel(), p["l"])))

    spec = dict(v=JP.positive(1.0), l=JP.positive(1.0), noise=JP.positive(0.3))
    theta0, unflatten = JP.init(spec)

    def logdensity(theta):
        p = unflatten(theta)
        lp = st.logpdf(build(p)(st.GPPPInput("f", jnp.asarray(x)), p["noise"]), jnp.asarray(y))
        return lp - 0.5 * jnp.sum(theta**2)

    return logdensity, theta0


def _port_batched(fn, thetas):
    grad, val = torch.func.vmap(torch.func.grad_and_value(fn))(torch.as_tensor(thetas))
    return val.numpy(), grad.numpy()


def test_nuts_logdensity_matches_jax_vmap():
    data = E.nuts_data(60, torch.float64, "cpu")
    t_fn, t_theta0, _ = E.nuts_logdensity(data)
    j_fn, j_theta0 = _jax_nuts_logdensity(*(a.numpy() for a in data))
    np.testing.assert_allclose(t_theta0.numpy(), np.asarray(j_theta0), rtol=1e-15)
    thetas = _thetas(t_theta0.numpy())
    j_val, j_grad = jax.vmap(jax.value_and_grad(j_fn))(jnp.asarray(thetas))
    val, grad = _port_batched(t_fn, thetas)
    np.testing.assert_allclose(val, np.asarray(j_val), rtol=1e-10)
    np.testing.assert_allclose(grad, np.asarray(j_grad), rtol=1e-10, atol=1e-10 * np.abs(j_grad).max())


@pytest.mark.parametrize("model", ["SE", "Matern32"])
def test_smc_loglike_matches_jax_vmap(model):
    data = E.smc_data(50, torch.float64, "cpu")
    x, y = (jnp.asarray(a.numpy()) for a in data)
    kern = {"SE": st.SEKernel, "Matern32": st.Matern32Kernel}[model]

    @st.gppp
    def build(p):
        return dict(f=st.GP(p["v"] * st.with_lengthscale(kern(), p["l"])))

    def j_loglike(q):
        p = dict(v=jnp.exp(q[0]), l=jnp.exp(q[1]), noise=jnp.exp(q[2]))
        return st.logpdf(build(p)(st.GPPPInput("f", x), p["noise"]), y)

    qs = np.random.default_rng(4).normal(size=(8, 3))
    j_val, j_grad = jax.vmap(jax.value_and_grad(j_loglike))(jnp.asarray(qs))
    val, grad = _port_batched(E.smc_loglike(E.SMC_BUILDS[model], data), qs)
    np.testing.assert_allclose(val, np.asarray(j_val), rtol=1e-10)
    np.testing.assert_allclose(grad, np.asarray(j_grad), rtol=1e-10, atol=1e-10 * np.abs(j_grad).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_vmapped_equals_a_loop_over_chains(dtype):
    data = E.nuts_data(60, dtype, "cpu")
    fn, theta0, _ = E.nuts_logdensity(data)
    thetas = torch.as_tensor(_thetas(theta0.numpy(), 5, seed=1), dtype=dtype)
    grad, val = torch.func.vmap(torch.func.grad_and_value(fn))(thetas)
    for c in range(len(thetas)):
        th = thetas[c].clone().requires_grad_(True)
        v = fn(th)
        (g,) = torch.autograd.grad(v, th)
        # the same arithmetic per chain: to the dtype's rounding
        rtol = 1e-12 if dtype == torch.float64 else 1e-5
        np.testing.assert_allclose(val[c].item(), v.item(), rtol=rtol)
        np.testing.assert_allclose(grad[c].numpy(), g.numpy(), rtol=rtol, atol=rtol * g.abs().max().item())


@pytest.mark.parametrize("kind", sorted(tkm.KINDS))
@pytest.mark.parametrize("dim", [1, 2])
def test_batched_plain_kernel_equals_unbatched_per_entry(kind, dim):
    rng = np.random.default_rng(dim)
    x = torch.as_tensor(rng.normal(size=(4, 37, dim)))
    y = torch.as_tensor(rng.normal(size=(4, 23, dim)))
    var = torch.as_tensor(rng.uniform(0.5, 2.0, size=4))
    for yy in (None, y):
        K = tkm.kernelmatrix_batched_forward(x, yy, kind, var)
        for b in range(4):
            Kb = tkm.kernelmatrix_plain(x[b], None if yy is None else yy[b], kind, var[b])
            np.testing.assert_array_equal(K[b].numpy(), Kb.numpy())
        if yy is None:
            np.testing.assert_array_equal(K.diagonal(dim1=-2, dim2=-1).numpy(),
                                          var[:, None].expand(4, 37).numpy())


def test_batched_vjp_equals_unbatched_per_entry():
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(size=(3, 29, 2)))
    y = torch.as_tensor(rng.normal(size=(3, 17, 2)))
    var = torch.as_tensor(rng.uniform(0.5, 2.0, size=3))
    for kind in ("se", "matern32"):
        for yy in (None, y):
            m = 29 if yy is None else 17
            K_bar = torch.as_tensor(rng.normal(size=(3, 29, m)))
            gx, gy, gv = tkm.kernelmatrix_vjp(x, yy, kind, var, K_bar)
            for b in range(3):
                rx, ry, rv = tkm.kernelmatrix_vjp(x[b], None if yy is None else yy[b], kind, var[b], K_bar[b])
                np.testing.assert_allclose(gx[b].numpy(), rx.numpy(), rtol=1e-12, atol=1e-12)
                np.testing.assert_allclose(gv[b].item(), rv.item(), rtol=1e-12)
                if yy is not None:
                    np.testing.assert_allclose(gy[b].numpy(), ry.numpy(), rtol=1e-12, atol=1e-12)


def test_one_batched_forward_and_vjp_per_evaluation(monkeypatch):
    calls = {"forward": [], "vjp": []}
    fwd, vjp = tkm.kernelmatrix_batched_forward, tkm.kernelmatrix_vjp

    def spy_fwd(x, *args):
        calls["forward"].append(tuple(x.shape))
        return fwd(x, *args)

    def spy_vjp(x, *args):
        calls["vjp"].append(tuple(x.shape))
        return vjp(x, *args)

    monkeypatch.setattr(tkm, "kernelmatrix_batched_forward", spy_fwd)
    monkeypatch.setattr(tkm, "kernelmatrix_vjp", spy_vjp)
    data = E.nuts_data(40, torch.float64, "cpu")
    fn, theta0, _ = E.nuts_logdensity(data)
    thetas = torch.as_tensor(_thetas(theta0.numpy(), 7))
    torch.func.vmap(torch.func.grad_and_value(fn))(thetas)
    assert calls == {"forward": [(7, 40, 1)], "vjp": [(7, 40, 1)]}


def test_vmapped_covariance_never_takes_the_blocked_path(monkeypatch):
    seen = []
    use_blocked = tchol._use_blocked

    def spy(K):
        seen.append(is_vmapped(K))
        return use_blocked(K)

    monkeypatch.setattr(tchol, "_use_blocked", spy)
    blocked_calls = []
    real_blocked = tbc.cholesky_blocked_padded

    def count_blocked(*args, **kwargs):
        blocked_calls.append(1)
        return real_blocked(*args, **kwargs)

    monkeypatch.setattr(tbc, "cholesky_blocked_padded", count_blocked)
    data = E.nuts_data(60, torch.float64, "cpu")
    fn, theta0, _ = E.nuts_logdensity(data)
    thetas = torch.as_tensor(_thetas(theta0.numpy(), 4, seed=2))
    ref = torch.func.vmap(torch.func.grad_and_value(fn))(thetas)
    with stt.config.chol_backend("blocked"):
        got = torch.func.vmap(torch.func.grad_and_value(fn))(thetas)
        assert seen and all(seen) and not blocked_calls
        # an unbatched covariance still takes the blocked route
        v = fn(theta0)
    assert blocked_calls and not seen[-1] and np.isfinite(v.item())
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_is_vmapped_sees_through_grad_wrappers():
    seen = []

    def f(t):
        seen.append(is_vmapped(t))
        return torch.sum(t * t)

    torch.func.vmap(torch.func.grad(f))(torch.ones(3, 2))
    torch.func.grad(f)(torch.ones(2))
    f(torch.ones(2))
    assert seen == [True, False, False]


def test_noise_is_added_in_place_outside_transforms():
    K = torch.eye(3)
    out = stt.finite_gp.DiagNoise(torch.tensor(0.5)).add_to(K)
    assert out.data_ptr() == K.data_ptr() and float(K[0, 0]) == 1.5


@pytest.mark.parametrize("kind", ["se", "matern52"])
def test_vmapped_cross_kernel_matrix_and_its_vjp(kind):
    """A cross matrix (y given) under `vmap(grad_and_value)`, with both
    inputs and the variance batched, against a loop (rtol 1e-12)."""
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.normal(size=(31, 2)))
    y = torch.as_tensor(rng.normal(size=(17, 2)))
    w = torch.as_tensor(rng.normal(size=(31, 17)))

    def f(t):
        K = tkm.kernelmatrix(x / torch.exp(t[0]), y / torch.exp(t[1]), kind, torch.exp(t[2]))
        return torch.sum(w * K)

    ts = torch.as_tensor(rng.normal(size=(5, 3)) * 0.3)
    grad, val = torch.func.vmap(torch.func.grad_and_value(f))(ts)
    for c in range(5):
        t = ts[c].clone().requires_grad_(True)
        v = f(t)
        (g,) = torch.autograd.grad(v, t)
        np.testing.assert_allclose(val[c].item(), v.item(), rtol=1e-12)
        np.testing.assert_allclose(grad[c].numpy(), g.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("make", [lambda: stt.RationalQuadraticKernel(alpha=1.5),
                                  lambda: stt.PeriodicKernel(r=torch.tensor([1.5], dtype=torch.float64)),
                                  lambda: stt.SEKernel() + stt.Matern12Kernel()],
                         ids=["rational_quadratic", "periodic", "sum"])
def test_vmapped_logdensity_of_other_kernels_equals_a_loop(make):
    """Kernels off kernel 1's path (their eˣ is `_Exp`, whose `vmap` rule is
    generated) and a sum through kernel 1 twice, under `vmap(grad)`,
    against a loop (rtol 1e-12)."""
    x = torch.linspace(-3.0, 3.0, 40, dtype=torch.float64)
    y = torch.sin(x)

    @stt.gppp
    def build(p):
        return dict(f=stt.GP(p["v"] * stt.with_lengthscale(make(), p["l"])))

    def fn(t):
        p = dict(v=torch.exp(t[0]), l=torch.exp(t[1]))
        return stt.logpdf(build(p)(stt.GPPPInput("f", x), 0.1), y)

    ts = torch.as_tensor(np.random.default_rng(3).normal(size=(4, 2)) * 0.3)
    grad, val = torch.func.vmap(torch.func.grad_and_value(fn))(ts)
    for c in range(4):
        t = ts[c].clone().requires_grad_(True)
        v = fn(t)
        (g,) = torch.autograd.grad(v, t)
        np.testing.assert_allclose(val[c].item(), v.item(), rtol=1e-12)
        np.testing.assert_allclose(grad[c].numpy(), g.numpy(), rtol=1e-12, atol=1e-12)

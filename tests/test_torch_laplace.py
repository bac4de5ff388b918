"""The port's Laplace approximation against the JAX package's: the log
evidence and its gradient in the hyperparameters through the unrolled
damped Newton steps, the mode, the last step and the posterior, for each
likelihood; against exact inference with a Gaussian likelihood; across
processes of a GPPP; and on the blocked route.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: f64 to rtol 1e-10 (gradients and modes against their largest
entry); f32 to rtol 1e-4 (evidence) and 5e-3 (gradients).  Each fit takes
20 Newton steps, the example's count: once converged, the five candidate
steps differ in Ψ by rounding only, and the two packages may keep
different ones, which shows at 1e-8 after 8 steps and not after 20."""

from contextlib import ExitStack

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu
import stheno_tpu as st
import stheno_tpu_torch as stt
from stheno_tpu.inference import laplace as j_laplace
from stheno_tpu.inference import likelihoods as JL
from stheno_tpu_torch.inference import laplace as t_laplace
from stheno_tpu_torch.inference import likelihoods as TL
from stheno_tpu_torch.inference.laplace import _d_log_prob
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _data(kind, n=60, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-4, 4, n))
    f = 1.5 * np.sin(x)
    y = {"bernoulli": (rng.uniform(size=n) < 0.5 * (1 + np.tanh(f))).astype(float),
         "poisson": rng.poisson(np.exp(0.5 * f)).astype(float),
         "student_t": f + 0.3 * rng.standard_t(4, size=n),
         "gaussian": f + 0.3 * rng.normal(size=n)}[kind]
    return x, y


LIKS = {
    "bernoulli": (JL.BernoulliLikelihood, TL.BernoulliLikelihood, ()),
    "poisson": (JL.PoissonLikelihood, TL.PoissonLikelihood, ()),
    "student_t": (JL.StudentTLikelihood, TL.StudentTLikelihood, (4.0, 0.5)),
    "gaussian": (JL.GaussianLikelihood, TL.GaussianLikelihood, (0.09,)),
}


def _jax_fit(x, y, lik, iters):
    def fn(v, ell):
        with st.GPC():
            g = st.GP(v * st.with_lengthscale(st.SEKernel(), ell))
        res = j_laplace(g(x, 1e-9), y, lik, num_iters=iters)
        return res.log_evidence, (res.f_hat, res.newton_decrement,
                                  res.posterior.mean(x[:7] + 0.1), res.posterior.var(x[:7] + 0.1))

    return fn


def _torch_fit(x, y, lik, iters, v, ell):
    with stt.GPC():
        g = stt.GP(v * stt.with_lengthscale(stt.SEKernel(), ell))
    return t_laplace(g(x, 1e-9), y, lik, num_iters=iters)


def _central_differences(fn, v, ell, dtype, h=1e-5):
    h = h if dtype == torch.float64 else 1e-2
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return [(fn(t(v + h), t(ell)) - fn(t(v - h), t(ell))) / (2 * h),
            (fn(t(v), t(ell + h)) - fn(t(v), t(ell - h))) / (2 * h)]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kind", sorted(LIKS))
def test_laplace_matches_reference(kind, dtype):
    """log evidence and its gradient in (v, ℓ), the mode, the last Newton
    step and the posterior mean and variance at 7 points."""
    jdt, tdt = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}[dtype]
    rtol, grtol = (1e-10, 1e-10) if dtype == "f64" else (1e-4, 5e-3)
    x, y = _data(kind)
    jcls, tcls, args = LIKS[kind]
    fn = _jax_fit(jnp.asarray(x, dtype=jdt), jnp.asarray(y, dtype=jdt), jcls(*args), 20)
    (jlz, (jf, jstep, jm, jv)), jg = jax.jit(jax.value_and_grad(fn, argnums=(0, 1), has_aux=True))(
        jnp.asarray(1.3, dtype=jdt), jnp.asarray(0.9, dtype=jdt))
    v = torch.tensor(1.3, dtype=tdt, requires_grad=True)
    ell = torch.tensor(0.9, dtype=tdt, requires_grad=True)
    tx = torch.as_tensor(x, dtype=tdt)
    res = _torch_fit(tx, torch.as_tensor(y, dtype=tdt), tcls(*args), 20, v, ell)
    grads = torch.autograd.grad(res.log_evidence, (v, ell))
    np.testing.assert_allclose(res.log_evidence.item(), float(jlz), rtol=rtol)
    gtol = grtol
    if not np.isfinite(np.asarray(jg)).all():
        # Student-t: where the curvature is clipped to W = 0, the reference's
        # gradient of √W is inf·0 = NaN; the port's clamp passes no gradient
        # there (the true derivative, 0), so its gradient is held to central
        # differences of its own log evidence
        assert kind == "student_t"
        jg = _central_differences(lambda a, b: _torch_fit(tx, torch.as_tensor(y, dtype=tdt),
                                                           tcls(*args), 20, a, b).log_evidence.item(),
                                  1.3, 0.9, tdt)
        gtol = 1e-6 if dtype == "f64" else 5e-2
    for g, w in zip(grads, jg):
        np.testing.assert_allclose(g.item(), float(w), rtol=gtol)
    jf = np.asarray(jf)
    np.testing.assert_allclose(res.f_hat.detach().numpy(), jf, rtol=0, atol=grtol * np.abs(jf).max())
    if dtype == "f64":
        np.testing.assert_allclose(res.newton_decrement.item(), float(jstep), rtol=1e-6, atol=1e-13)
    with torch.no_grad():
        m, var = res.posterior.mean_and_var(tx[:7] + 0.1)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=grtol, atol=grtol * 1e-2)
    np.testing.assert_allclose(var.numpy(), np.asarray(jv), rtol=grtol, atol=grtol * 1e-2)


def test_gaussian_likelihood_equals_exact_inference():
    """With a Gaussian likelihood one Newton step reaches the mode, the
    Laplace evidence is the exact logpdf and the posterior is the exact
    one."""
    x, y = _data("gaussian")
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    with stt.GPC():
        g = stt.GP(1.3 * stt.with_lengthscale(stt.SEKernel(), 0.9))
    res = t_laplace(g(tx, 1e-9), ty, TL.GaussianLikelihood(0.09), num_iters=5)
    exact_fx = g(tx, 0.09 + 1e-9)
    np.testing.assert_allclose(res.log_evidence.item(), stt.logpdf(exact_fx, ty).item(), rtol=1e-8)
    post = stt.posterior(exact_fx, ty)
    xq = torch.linspace(-3.5, 3.5, 15, dtype=torch.float64)
    np.testing.assert_allclose(res.posterior.mean(xq).numpy(), post.mean(xq).numpy(), atol=1e-7)
    np.testing.assert_allclose(res.posterior.cov(xq).numpy(), post.cov(xq).numpy(), atol=1e-7)
    np.testing.assert_allclose(res.posterior.cov2(xq, xq).numpy(), post.cov2(xq, xq).numpy(), atol=1e-7)
    np.testing.assert_allclose(res.posterior.var2(xq, xq).numpy(), post.var2(xq, xq).numpy(), atol=1e-7)
    assert res.newton_decrement.item() < 1e-8


def test_poisson_counts_across_processes_of_a_gppp():
    """Counts observed through f3 = trend + wiggle; the latent trend is
    read off the Laplace posterior at the same inputs, against the
    reference."""
    rng = np.random.default_rng(3)
    xc = np.sort(rng.uniform(-4, 4, 50))
    counts = rng.poisson(np.exp(np.sin(xc))).astype(float)

    def jbuild():
        @st.gppp
        def build():
            trend = st.GP(st.with_lengthscale(st.SEKernel(), 2.5))
            wiggle = st.GP(0.3 * st.with_lengthscale(st.Matern32Kernel(), 0.4))
            return dict(trend=trend, wiggle=wiggle, f3=trend + wiggle)
        return build()

    @stt.gppp
    def tbuild():
        trend = stt.GP(stt.with_lengthscale(stt.SEKernel(), 2.5))
        wiggle = stt.GP(0.3 * stt.with_lengthscale(stt.Matern32Kernel(), 0.4))
        return dict(trend=trend, wiggle=wiggle, f3=trend + wiggle)

    jp = jbuild()
    jres = jax.jit(lambda: j_laplace(jp(st.GPPPInput("f3", jnp.asarray(xc)), 1e-9), jnp.asarray(counts),
                                     JL.PoissonLikelihood(), num_iters=15))()
    jtrend = jax.jit(lambda: jres.posterior.mean_and_var(st.GPPPInput("trend", jnp.asarray(xc))))()
    tp = tbuild()
    tx = torch.as_tensor(xc)
    res = t_laplace(tp(stt.GPPPInput("f3", tx), 1e-9), counts, TL.PoissonLikelihood(), num_iters=15)
    m, v = res.posterior.mean_and_var(stt.GPPPInput("trend", tx))
    np.testing.assert_allclose(res.log_evidence.item(), float(jres.log_evidence), rtol=1e-10)
    np.testing.assert_allclose(m.numpy(), np.asarray(jtrend[0]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(jtrend[1]), rtol=1e-10, atol=1e-12)


def test_laplace_on_the_blocked_route_matches_reference():
    """N = 512 Bernoulli labels with both packages on the blocked route
    (each of 20 Newton steps factors B in two panels of 256), f64: log evidence
    and gradient to rtol 1e-10; and f32 on the kernels' plain versions
    against f64."""
    rng = np.random.default_rng(8)
    x = np.sort(rng.uniform(-17, 17, 512))
    y = (rng.uniform(size=512) < 0.5 * (1 + np.tanh(2 * np.sin(x)))).astype(float)
    with ExitStack() as stack:
        stack.enter_context(stheno_tpu.config.chol_backend("blocked"))
        stack.enter_context(stheno_tpu.config.bwd_params(block=256))
        fn = _jax_fit(jnp.asarray(x), jnp.asarray(y), JL.BernoulliLikelihood(), 20)
        (jlz, _), jg = jax.jit(jax.value_and_grad(fn, argnums=(0, 1), has_aux=True))(
            jnp.asarray(1.0), jnp.asarray(0.5))
    out = {}
    with stt.config.chol_backend("blocked"), stt.config.bwd_params(block=256):
        for dt in (torch.float64, torch.float32):
            v = torch.tensor(1.0, dtype=dt, requires_grad=True)
            ell = torch.tensor(0.5, dtype=dt, requires_grad=True)
            res = _torch_fit(torch.as_tensor(x, dtype=dt), torch.as_tensor(y, dtype=dt),
                             TL.BernoulliLikelihood(), 20, v, ell)
            out[dt] = (res.log_evidence.item(), [g.item() for g in torch.autograd.grad(
                res.log_evidence, (v, ell))])
    lz, g = out[torch.float64]
    np.testing.assert_allclose(lz, float(jlz), rtol=1e-10)
    np.testing.assert_allclose(g, [float(a) for a in jg], rtol=1e-10)
    lz32, g32 = out[torch.float32]
    np.testing.assert_allclose(lz32, lz, rtol=1e-4)
    np.testing.assert_allclose(g32, g, rtol=5e-3)


def test_curvature_is_clipped_for_student_t():
    """W = −∂² log p clipped at 0 where Student-t is not log-concave, and
    the derivatives match finite differences."""
    lik = TL.StudentTLikelihood(3.0, 0.5)
    f = torch.linspace(-4, 4, 41, dtype=torch.float64)
    y = torch.zeros(41, dtype=torch.float64)
    dll, w = _d_log_prob(lik, f, y)
    assert bool((w >= 0).all()) and bool((w == 0).any())
    h = 1e-5
    fd = (lik.log_prob(f + h, y) - lik.log_prob(f - h, y)) / (2 * h)
    np.testing.assert_allclose(dll.numpy(), fd.numpy(), rtol=1e-6, atol=1e-8)

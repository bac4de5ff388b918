"""The port's likelihoods against the JAX package's: `log_prob`,
`variational_expectation` and `predictive_mean_var` of each, with their
gradients in the inputs (and in the likelihood's own parameters), and
`convert.likelihood_from_numpy`.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: f64 to rtol 1e-10 (values elementwise; gradients against their
largest entry); f32 to rtol 1e-5, a few float32 roundings of a 20-node
quadrature."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stheno_tpu.inference import likelihoods as JL
from stheno_tpu_torch.convert import likelihood_from_numpy
from stheno_tpu_torch.inference import likelihoods as TL
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

N = 64

#: (name, JAX likelihood, observations of its kind)
CASES = {
    "gaussian": (lambda: JL.GaussianLikelihood(0.3), "real"),
    "bernoulli_probit": (lambda: JL.BernoulliLikelihood(), "binary"),
    "bernoulli_logit": (lambda: JL.BernoulliLikelihood(link="logit"), "binary"),
    "poisson_exp": (lambda: JL.PoissonLikelihood(), "count"),
    "poisson_softplus": (lambda: JL.PoissonLikelihood(link="softplus"), "count"),
    "student_t": (lambda: JL.StudentTLikelihood(4.5, 0.7), "real"),
}


def _inputs(kind, seed=17):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=N)
    var = 0.05 + rng.uniform(size=N)
    f = rng.normal(size=N)
    y = {"real": rng.normal(size=N), "binary": (rng.uniform(size=N) < 0.5).astype(float),
         "count": rng.poisson(2.0, size=N).astype(float)}[kind]
    return mu, var, f, y


def _methods(lik, y):
    """Each method as a scalar or vector function of (mu, var) (f, var for
    log_prob), so one value-and-gradient check covers all three."""
    return {
        "log_prob": lambda f, var: lik.log_prob(f, y),
        "variational_expectation": lambda mu, var: lik.variational_expectation(mu, var, y),
        "predictive_mean": lambda mu, var: lik.predictive_mean_var(mu, var)[0],
        "predictive_var": lambda mu, var: lik.predictive_mean_var(mu, var)[1],
    }


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_likelihood_matches_reference(name, dtype):
    make, kind = CASES[name]
    mu, var, f, y = _inputs(kind)
    jdt, tdt = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}[dtype]
    rtol = 1e-10 if dtype == "f64" else 1e-5
    jlik = make()
    tlik = likelihood_from_numpy(jlik, dtype=tdt, device="cpu")
    assert type(tlik).__name__ == type(jlik).__name__
    jm = _methods(jlik, jnp.asarray(y, dtype=jdt))
    tm = _methods(tlik, torch.as_tensor(y, dtype=tdt))
    for method in jm:
        first = f if method == "log_prob" else mu
        a = jnp.asarray(first, dtype=jdt)
        b = jnp.asarray(var, dtype=jdt)
        want = jax.jit(jm[method])(a, b)
        # the gradient of the sum in both inputs
        wga, wgb = jax.jit(jax.grad(lambda p, q: jnp.sum(jm[method](p, q)), argnums=(0, 1)))(a, b)
        ta = torch.tensor(first, dtype=tdt, requires_grad=True)
        tb = torch.tensor(var, dtype=tdt, requires_grad=True)
        got = tm[method](ta, tb)
        assert got.dtype == tdt, method
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=rtol * 1e-2,
                                   err_msg=method)
        grads = torch.autograd.grad(got.sum(), (ta, tb), allow_unused=True)
        for g, w in zip(grads, (wga, wgb)):
            w = np.asarray(w)
            g = np.zeros_like(w) if g is None else g.numpy()
            np.testing.assert_allclose(g, w, rtol=0, atol=rtol * max(np.abs(w).max(), 1e-300),
                                       err_msg=method)


@pytest.mark.parametrize("name", ["gaussian", "student_t"])
def test_likelihood_parameters_get_gradients(name):
    """The likelihood's own parameters are differentiable: the gradient of
    the variational expectation in them, f64, against the reference's."""
    make, kind = CASES[name]
    mu, var, _, y = _inputs(kind)
    jlik = make()
    fields = {"gaussian": ("variance",), "student_t": ("df", "scale")}[name]
    jvals = [float(getattr(jlik, k)) for k in fields]

    def jfun(*ps):
        lik = type(jlik)(*ps)
        return lik.variational_expectation(jnp.asarray(mu), jnp.asarray(var), jnp.asarray(y))

    want = jax.grad(jfun, argnums=tuple(range(len(fields))))(*(jnp.asarray(v) for v in jvals))
    ps = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in jvals]
    tlik = getattr(TL, type(jlik).__name__)(*ps)
    val = tlik.variational_expectation(torch.as_tensor(mu), torch.as_tensor(var), torch.as_tensor(y))
    got = torch.autograd.grad(val, ps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-10)


def test_quadrature_agrees_with_the_closed_forms():
    """The generic Gauss–Hermite expectation of the base class against the
    closed forms it is overridden by (Gaussian, Poisson-exp), and the
    probit predictive against quadrature."""
    mu, var, _, y = _inputs("count")
    mu, var, y = (torch.as_tensor(a) for a in (mu, var, y))
    for lik in (TL.GaussianLikelihood(0.4), TL.PoissonLikelihood()):
        quad = TL.Likelihood.variational_expectation(lik, mu, var, y)
        np.testing.assert_allclose(quad.item(), lik.variational_expectation(mu, var, y).item(),
                                   rtol=1e-9)
    probit = TL.BernoulliLikelihood()
    p_closed, _ = probit.predictive_mean_var(mu, var)
    p_quad = probit._quad(probit.conditional_mean, mu, var)
    np.testing.assert_allclose(p_closed.numpy(), p_quad.numpy(), rtol=1e-6, atol=1e-8)


def test_negative_f32_variances_are_clamped():
    """A marginal variance a little below zero (f32 cancellation) gives a
    finite quadrature, as at the reference's clamp."""
    mu = torch.zeros(4)
    var = torch.tensor([-1e-7, 0.0, 1e-3, 0.5])
    out = TL.BernoulliLikelihood(link="logit").variational_expectation(mu, var, torch.ones(4))
    assert torch.isfinite(out)


def test_likelihood_from_numpy_rejects_unknown_classes():
    class Mystery:
        pass

    with pytest.raises(ValueError, match="unknown likelihood"):
        likelihood_from_numpy(Mystery(), device="cpu")

"""The port's SVGP against the JAX package's: `svgp_elbo` (Gaussian and with
a likelihood, minibatch scale included) with its gradient in the
hyperparameters, the inducing inputs and the variational state;
`svgp_optimal_gaussian`, at which the bound equals the collapsed `elbo`;
`svgp_posterior`; the interdomain form on a GPPP; and the blocked route.

Inputs are made with numpy from a seed and fed to both packages; the JAX
variational state is carried across with `convert.svgp_from_numpy`.
Tolerances: f64 to rtol 1e-10 (gradients against their largest entry);
f32 to rtol 1e-4 (values) and 5e-3 (gradients)."""

from contextlib import ExitStack

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu
import stheno_tpu as st
import stheno_tpu_torch as stt
from stheno_tpu.inference import likelihoods as JL
from stheno_tpu.inference import svgp as JS
from stheno_tpu.models.workloads import pseudo_points_model as j_model
from stheno_tpu_torch import entry
from stheno_tpu_torch.convert import svgp_from_numpy
from stheno_tpu_torch.inference import likelihoods as TL
from stheno_tpu_torch.inference import svgp as TS
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _data(n=80, m=15, seed=42):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, n))
    z = np.linspace(-3.0, 3.0, m)
    y = np.sin(2 * x) + 0.1 * rng.normal(size=n)
    return x, y, z


def _q_state(m, seed=9):
    """A variational state away from both the prior and the optimum."""
    rng = np.random.default_rng(seed)
    return 0.3 * rng.normal(size=m), np.eye(m) * 0.8 + np.tril(0.05 * rng.normal(size=(m, m)), -1)


def _jax_bound(x, y, z, scale=1.0, likelihood=None, noise=0.1):
    """−svgp_elbo of the JAX package in (v, l, z, q_mu, q_sqrt)."""

    def fn(v, ell, zz, q_mu, q_sqrt):
        with st.GPC():
            f = st.GP(v * st.with_lengthscale(st.SEKernel(), ell))
        fz = f(zz, 1e-9)
        fx = f(x, 1e-9 if likelihood is not None else noise)
        return -JS.svgp_elbo(JS.SVGP(fz, q_mu, q_sqrt), fx, y, scale=scale, likelihood=likelihood)

    return fn


def _torch_bound(x, y, scale=1.0, likelihood=None, noise=0.1):
    def fn(v, ell, zz, q_mu, q_sqrt):
        with stt.GPC():
            f = stt.GP(v * stt.with_lengthscale(stt.SEKernel(), ell))
        fz = f(zz, 1e-9)
        fx = f(x, 1e-9 if likelihood is not None else noise)
        return -TS.svgp_elbo(TS.SVGP(fz, q_mu, q_sqrt), fx, y, scale=scale, likelihood=likelihood)

    return fn


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("case", ["gaussian", "gaussian_minibatch", "bernoulli", "poisson"])
def test_svgp_elbo_and_gradient_match_reference(case, dtype):
    """The bound and its gradient in (v, ℓ, z, q_mu, q_sqrt)."""
    jdt, tdt = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}[dtype]
    rtol, grtol = (1e-10, 1e-10) if dtype == "f64" else (1e-4, 5e-3)
    x, y, z = _data()
    q_mu, q_sqrt = _q_state(len(z))
    scale, jlik, tlik = 1.0, None, None
    if case == "gaussian_minibatch":
        x, y, scale = x[:32], y[:32], 80 / 32
    elif case == "bernoulli":
        y = (y > 0).astype(float)
        jlik, tlik = JL.BernoulliLikelihood(), TL.BernoulliLikelihood()
    elif case == "poisson":
        y = np.round(np.exp(y))
        jlik, tlik = JL.PoissonLikelihood(), TL.PoissonLikelihood()
    args = (1.4, 0.8, z, q_mu, q_sqrt)
    jargs = [jnp.asarray(a, dtype=jdt) for a in args]
    jfn = _jax_bound(jnp.asarray(x, dtype=jdt), jnp.asarray(y, dtype=jdt), None, scale, jlik)
    jval, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(5))))(*jargs)
    targs = [torch.tensor(np.asarray(a), dtype=tdt, requires_grad=True) for a in args]
    tfn = _torch_bound(torch.as_tensor(x, dtype=tdt), torch.as_tensor(y, dtype=tdt), scale, tlik)
    val = tfn(*targs)
    grads = torch.autograd.grad(val, targs)
    np.testing.assert_allclose(val.item(), float(jval), rtol=rtol)
    for g, w in zip(grads, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=grtol * np.abs(w).max())


def test_optimal_q_gives_the_collapsed_bound_and_the_vfe_posterior():
    """At `svgp_optimal_gaussian` the SVGP bound equals `elbo` (rtol 1e-10,
    the reference's own identity), its state equals the reference's, and
    `svgp_posterior` equals `posterior_vfe` and the reference's posterior."""
    x, y, z = _data()
    with st.GPC():
        jf = st.GP(1.4 * st.with_lengthscale(st.SEKernel(), 0.8))
    with stt.GPC():
        tf = stt.GP(1.4 * stt.with_lengthscale(stt.SEKernel(), 0.8))
    jfx, jfz = jf(jnp.asarray(x), 0.1), jf(jnp.asarray(z), 1e-9)
    tx, tz = torch.as_tensor(x), torch.as_tensor(z)
    tfx, tfz = tf(tx, 0.1), tf(tz, 1e-9)
    jq = JS.svgp_optimal_gaussian(JS.svgp_init(jfz), jfx, jnp.asarray(y))
    q0 = TS.svgp_init(tfz)
    assert q0.q_mu.dtype == torch.float64 and bool((q0.q_sqrt == torch.eye(15, dtype=torch.float64)).all())
    tq = TS.svgp_optimal_gaussian(q0, tfx, y)
    np.testing.assert_allclose(tq.q_mu.numpy(), np.asarray(jq.q_mu), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tq.q_sqrt.numpy(), np.asarray(jq.q_sqrt), rtol=1e-10, atol=1e-12)
    titsias = stt.elbo(stt.VFE(tfz), tfx, y).item()
    assert TS.svgp_elbo(q0, tfx, y).item() <= titsias <= stt.logpdf(tfx, y).item()
    np.testing.assert_allclose(TS.svgp_elbo(tq, tfx, y).item(), titsias, rtol=1e-10)
    # the reference's state carried across gives the same bound
    carried = svgp_from_numpy(jq, tfz, device="cpu")
    np.testing.assert_allclose(TS.svgp_elbo(carried, tfx, y).item(), titsias, rtol=1e-10)
    xs = np.linspace(-2.5, 2.5, 41)
    txs = torch.as_tensor(xs)
    post, vfe = TS.svgp_posterior(tq), stt.posterior_vfe(stt.VFE(tfz), tfx, y)
    jpost = JS.svgp_posterior(jq)
    for a, b in ((post.mean(txs), vfe.mean(txs)), (post.var(txs), vfe.var(txs)),
                 (post.cov2(txs, txs[:5]), vfe.cov2(txs, txs[:5]))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(post.mean(txs).numpy(), np.asarray(jpost.mean(jnp.asarray(xs))),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(post.cov(txs).numpy(), np.asarray(jpost.cov(jnp.asarray(xs))),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(post.var2(txs, txs).numpy(), post.var(txs).numpy(), rtol=1e-12)


def test_minibatch_terms_sum_to_the_full_data_term():
    """scale·(batch data terms) add up to the full one; the KL is charged
    once per call."""
    x, y, z = _data(n=64)
    with stt.GPC():
        f = stt.GP(1.4 * stt.with_lengthscale(stt.SEKernel(), 0.8))
    tx, tz = torch.as_tensor(x), torch.as_tensor(z)
    q = TS.svgp_optimal_gaussian(TS.svgp_init(f(tz, 1e-9)), f(tx, 0.1), y)
    full = TS.svgp_elbo(q, f(tx, 0.1), y)
    kl = -TS.svgp_elbo(q, f(tx[:0], 0.1), y[:0])
    e1 = TS.svgp_elbo(q, f(tx[:32], 0.1), y[:32])
    e2 = TS.svgp_elbo(q, f(tx[32:], 0.1), y[32:])
    np.testing.assert_allclose((e1 + e2 + kl).item(), full.item(), rtol=1e-12)
    with pytest.raises(TypeError, match="diagonal"):
        TS.svgp_elbo(q, f(tx, 0.1 * torch.eye(64, dtype=torch.float64)), y)


@pytest.mark.parametrize("route", ["torch", "blocked"])
def test_interdomain_svgp_on_the_pseudo_point_programme(route):
    """SVGP with inducing points in both latents of the pseudo-point
    programme, Bernoulli labels, a minibatch scale: value and gradient in
    (θ, z, q_mu, q_sqrt) against the reference, f64, on both routes (the
    blocked one with 2·256 inducing points, backward panels of 256)."""
    m = 256 if route == "blocked" else 12
    data = entry.pseudo_points_data(300, m, torch.float64, "cpu", seed=5, half_width=0.75 * m)
    x, y, z = (a.numpy() for a in data)
    labels = (y > 0).astype(float)
    q_mu, q_sqrt = _q_state(2 * m, seed=3)
    names = ("v1", "l1", "v2", "l2")
    vals = (0.8, 1.0, 0.8, 1.0)

    def jfn(v1, l1, v2, l2, zz, qm, qs):
        f = j_model(dict(v1=v1, l1=l1, v2=v2, l2=l2))
        fz = f(st.BlockData(st.GPPPInput("f1", zz), st.GPPPInput("f2", zz)), 1e-6)
        fx = f(st.GPPPInput("f3", jnp.asarray(x[:128])), 1e-6)
        return -JS.svgp_elbo(JS.SVGP(fz, qm, qs), fx, jnp.asarray(labels[:128]), scale=300 / 128,
                             likelihood=JL.BernoulliLikelihood())

    stack = ExitStack()
    tstack = ExitStack()
    if route == "blocked":
        for pkg, s in ((stheno_tpu, stack), (stt, tstack)):
            s.enter_context(pkg.config.chol_backend("blocked"))
            s.enter_context(pkg.config.bwd_params(block=256))
    with stack:
        jval, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(7))))(
            *(jnp.asarray(v) for v in vals), jnp.asarray(z), jnp.asarray(q_mu), jnp.asarray(q_sqrt))
    targs = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in vals]
    targs += [torch.tensor(a, requires_grad=True) for a in (z, q_mu, q_sqrt)]
    with tstack:
        f = entry.build_pseudo_points(dict(zip(names, targs[:4])))
        zz = targs[4]
        fz = f(stt.BlockData(stt.GPPPInput("f1", zz), stt.GPPPInput("f2", zz)), 1e-6)
        fx = f(stt.GPPPInput("f3", data[0][:128]), 1e-6)
        val = -TS.svgp_elbo(TS.SVGP(fz, targs[5], targs[6]), fx, labels[:128], scale=300 / 128,
                            likelihood=TL.BernoulliLikelihood())
        grads = torch.autograd.grad(val, targs)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-10)
    for g, w in zip(grads, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-10 * np.abs(w).max())

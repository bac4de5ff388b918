"""The port's examples against the JAX examples (`examples/*.py`), on the
CPU in f64: the JAX example's model and the port's, built on the same
numpy inputs, give the same logpdf (or Laplace evidence, or ELBO) and
gradient to 1e-10 relative, and the same posterior marginals at the
example's query points to 1e-10; the Markov example's sampling helper and
loss against the reference at N = 2000; and the flax MLP's weights carried
into the deep kernel by `convert.mlp_from_numpy`, to 1e-12.  The JAX side
is jitted where its eager run would dominate the file's time.

Rows 5 and 6 (the user-defined processes) are in `test_torch_extension.py`.
"""

import importlib
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as st
import stheno_tpu_torch as stt
from stheno_tpu_torch.convert import mlp_from_numpy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-10
F64 = torch.float64


def jax_example(name):
    """The JAX example's module namespace (its `main` not run)."""
    return runpy.run_path(str(REPO / "examples" / f"{name}.py"), run_name=f"jax_example_{name}")


def port_example(name):
    return importlib.import_module(f"stheno_tpu_torch.examples.{name}")


def t(a):
    return torch.tensor(np.ascontiguousarray(a), dtype=F64)


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def _logpdf_parity(jf, tf, jx, tx, y, noise):
    """The JAX and port programmes at the same inputs: logpdf, its gradient
    in (y, noise), to RTOL."""
    jv, (jgy, jgs) = jax.jit(jax.value_and_grad(lambda yy, s: st.logpdf(jf(jx, s), yy),
                                                argnums=(0, 1)))(jnp.asarray(y), jnp.asarray(noise))
    ty, ts = t(y).requires_grad_(True), t(noise).requires_grad_(True)
    tv = stt.logpdf(tf(tx, ts), ty)
    tgy, tgs = torch.autograd.grad(tv, (ty, ts))
    close(tv, jv)
    close(tgy, jgy, atol=RTOL * float(np.abs(jgy).max()))
    close(tgs, jgs)


def _marginals_parity(jmarginals, tpost, tq, noise=1e-9):
    """`jmarginals()` (the JAX posterior's marginals, jitted) against the
    port posterior's at `tq`, each to RTOL of its largest value."""
    jm = jmarginals()
    with torch.no_grad():
        tm = stt.marginals(tpost(tq, noise))
    close(tm.mean, jm.mean, atol=RTOL * float(np.abs(jm.mean).max()))
    close(tm.var, jm.var, atol=RTOL * float(np.abs(jm.var).max()))


def _jax_marginals(jfx, y, jq, noise=1e-9):
    return jax.jit(lambda yy: st.marginals(st.posterior(jfx, yy)(jq, noise)))(jnp.asarray(y))


def _blocks(m, conv, pairs):
    return m.BlockData(*(m.GPPPInput(p, conv(x)) for p, x in pairs))


@pytest.mark.parametrize("name", ["process_decomposition", "naive_linear_mixing",
                                  "time_varying_blr", "sensor_fusion"])
def test_gppp_examples_match_the_reference(name):
    """The four GPPP examples' programmes: logpdf and gradient at the
    example's observation layout, and the joint posterior marginals at its
    query, on common numpy data."""
    rng = np.random.default_rng(5)
    J, T = jax_example(name), port_example(name)
    layouts = {
        "process_decomposition": ([("f3", np.sort(rng.uniform(-5, 5, 21)))], 0.05,
                                  [(p, np.linspace(-6, 6, 121)) for p in ("f1", "f2", "f3")]),
        "naive_linear_mixing": ([(p, rng.normal(size=n)) for p, n in (("g1", 10), ("g2", 4), ("g3", 7))],
                                0.1, [(p, np.linspace(-5, 5, 300)) for p in ("f1", "f2", "g1", "g2", "g3")]),
        "time_varying_blr": ([("y", np.sort(rng.uniform(0, 10, 250)))], 1e-2,
                             [(p, np.linspace(-2.5, 12.5, 500)) for p in ("w1", "w2", "f", "y")]),
        "sensor_fusion": ([("y1", np.sort(rng.uniform(0, 10, 3))), ("y2", np.sort(rng.uniform(0, 10, 10)))],
                          1e-6, [(p, np.linspace(-2.5, 12.5, 500)) for p in ("f", "y1", "y2")]),
    }
    obs, noise, query = layouts[name]
    jf, tf = J["model"](), T.model()
    jx, tx = _blocks(st, jnp.asarray, obs), _blocks(stt, t, obs)
    y = rng.normal(size=sum(len(x) for _, x in obs))
    _logpdf_parity(jf, tf, jx, tx, y, noise)
    tpost = stt.posterior(tf(tx, noise), t(y))
    _marginals_parity(lambda: _jax_marginals(jf(jx, noise), y, _blocks(st, jnp.asarray, query)),
                      tpost, _blocks(stt, t, query))


def test_sensor_fusion_model_defaults_are_the_example():
    """The parametrised programme at its defaults is the example's, and its
    hyperparameters reach the gradient."""
    T = port_example("sensor_fusion")
    x = T.data("cpu", 40, 30)
    y = torch.as_tensor(np.random.default_rng(1).normal(size=70), dtype=F64)
    theta = {k: torch.tensor(v, dtype=F64, requires_grad=True) for k, v in T.THETA.items()}
    val = T.nlml(theta, x, y)
    close(val, -stt.logpdf(T.model()(x, 1e-6), y), rtol=1e-13)
    grads = torch.autograd.grad(val, list(theta.values()))
    assert all(torch.isfinite(g) and g != 0 for g in grads)


def test_getting_started_matches_the_reference():
    """The tour's −logpdf and gradient in the flat θ of its spec (through
    `stretch` and the constrained noise), and the posterior over f1, f2 and
    f3 at its 200 plot points."""
    from stheno_tpu import params as JP

    J, T = jax_example("getting_started"), port_example("getting_started")
    rng = np.random.default_rng(3)
    x = np.linspace(-5, 5, 100)
    y = rng.normal(size=100)
    jspec = dict(l1=JP.positive(0.4), s1=JP.positive(0.2), l2=JP.positive(5.0), s2=JP.positive(1.0),
                 s_noise=JP.positive(0.1, lb=1e-3))
    jtheta0, junflatten = JP.init(jspec)
    theta = np.asarray(jtheta0) + 0.1 * rng.normal(size=5)

    def jnlml(th):
        tt = junflatten(th)
        return -st.logpdf(J["build_model"](tt)(st.GPPPInput("f3", jnp.asarray(x)),
                                               tt["s_noise"] + 1e-6), jnp.asarray(y))

    jv, jg = jax.jit(jax.value_and_grad(jnlml))(jnp.asarray(theta))
    ttheta0, tunflatten = stt.params.init(T.spec("cpu"))
    close(ttheta0, jtheta0)
    th = t(theta).requires_grad_(True)
    tv = T.nlml_fn(stt.GPPPInput("f3", t(x)), t(y), tunflatten)(th)
    (tg,) = torch.autograd.grad(tv, th)
    close(tv, jv)
    close(tg, jg)

    jt, tt = junflatten(jnp.asarray(theta)), tunflatten(t(theta))
    jfx = J["build_model"](jt)(st.GPPPInput("f3", jnp.asarray(x)), 0.02)
    tpost = stt.posterior(T.build_model(tt)(stt.GPPPInput("f3", t(x)), 0.02), t(y))
    xp = np.linspace(-7, 7, 200)
    for p in ("f3", "f2", "f1"):
        _marginals_parity(lambda: _jax_marginals(jfx, y, st.GPPPInput(p, jnp.asarray(xp))),
                          tpost, stt.GPPPInput(p, t(xp)))


def test_non_gaussian_likelihoods_match_the_reference():
    """The probit Laplace evidence and its gradient in (v, l) through the
    Newton steps, the Poisson Laplace posterior of the trend across the
    programme, and the non-conjugate SVGP's ELBO and gradient in (q_mu,
    q_sqrt)."""
    from stheno_tpu.graph import GPC as JGPC
    from stheno_tpu.inference import BernoulliLikelihood, PoissonLikelihood, laplace
    from stheno_tpu.inference.svgp import SVGP as JSVGP
    from stheno_tpu.inference.svgp import svgp_elbo

    T = port_example("non_gaussian_likelihoods")
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-4, 4, 120))
    y = (rng.uniform(size=120) < 0.5 + 0.4 * np.tanh(x)).astype(float)

    def jneg(v, l):  # noqa: E741
        g = st.GP(v * st.with_lengthscale(st.SEKernel(), l), gpc=JGPC())
        return -laplace(g(jnp.asarray(x), 1e-9), jnp.asarray(y), BernoulliLikelihood(),
                        num_iters=20).log_evidence

    jv, jg = jax.jit(jax.value_and_grad(jneg, argnums=(0, 1)))(1.3, 0.7)
    p = {"v": torch.tensor(1.3, dtype=F64, requires_grad=True),
         "l": torch.tensor(0.7, dtype=F64, requires_grad=True)}
    tv = T.neg_evidence(p, t(x), t(y))
    tg = torch.autograd.grad(tv, [p["v"], p["l"]])
    close(tv, jv)
    close(torch.stack(tg), np.asarray(jg))

    # Poisson counts on f3, the trend read off across the programme
    xc = np.sort(rng.uniform(-4, 4, 150))
    counts = rng.poisson(np.exp(np.sin(xc)))
    @st.gppp
    def jbuild():
        trend = st.GP(st.with_lengthscale(st.SEKernel(), 2.5))
        wiggle = st.GP(0.3 * st.with_lengthscale(st.Matern32Kernel(), 0.4))
        return dict(trend=trend, wiggle=wiggle, f3=trend + wiggle)

    def jpoisson(c):
        res = laplace(jbuild()(st.GPPPInput("f3", jnp.asarray(xc)), 1e-9), c, PoissonLikelihood(),
                      num_iters=30)
        return res.log_evidence, [res.posterior.mean(st.GPPPInput(q, jnp.asarray(xc)))
                                  for q in ("trend", "f3")]

    jlz, jms = jax.jit(jpoisson)(jnp.asarray(counts, float))
    tres = stt.inference.laplace(T.build({})(stt.GPPPInput("f3", t(xc)), 1e-9), t(counts),
                                 stt.inference.PoissonLikelihood(), num_iters=30)
    close(tres.log_evidence, jlz)
    for q, jm in zip(("trend", "f3"), jms):
        close(tres.posterior.mean(stt.GPPPInput(q, t(xc))), jm, atol=RTOL * float(np.abs(jm).max()))

    # the SVGP's ELBO at a non-trivial q
    z = np.linspace(-3.8, 3.8, 20)
    q_mu, q_sqrt = rng.normal(size=20), np.tril(0.3 * rng.normal(size=(20, 20))) + np.eye(20)
    jg_ = st.GP(1.3 * st.with_lengthscale(st.SEKernel(), 0.7), gpc=JGPC())

    def jelbo(mu, sq):
        q = JSVGP(jg_(jnp.asarray(z), 1e-9), mu, sq)
        return -svgp_elbo(q, jg_(jnp.asarray(x), 1e-9), jnp.asarray(y), likelihood=BernoulliLikelihood())

    jv, (jgm, jgs) = jax.jit(jax.value_and_grad(jelbo, argnums=(0, 1)))(jnp.asarray(q_mu),
                                                                         jnp.asarray(q_sqrt))
    g = T.se_gp(1.3, 0.7)
    tm, ts = t(q_mu).requires_grad_(True), t(q_sqrt).requires_grad_(True)
    tv = T.svgp_neg_elbo(stt.inference.SVGP(g(t(z), 1e-9), tm, ts), g, t(x), t(y))
    tgm, tgs = torch.autograd.grad(tv, (tm, ts))
    close(tv, jv)
    close(tgm, jgm, atol=RTOL * float(np.abs(jgm).max()))
    close(tgs, jgs, atol=RTOL * float(np.abs(jgs).max()))


def test_markov_sampling_helper_and_loss_match_the_reference():
    """At N = 2000: the discretised SDE (A, Q) against the reference's; the
    prior draw from the reference's own normal draws (its key 0 and
    `fold_in(key, 1)`) and its own factors, through the port's associative
    scan, against the reference's sequential one; the per-point −logpdf and
    its gradient in log θ; the posterior marginals at held-out sites.  The
    factors are the reference's because Q at the smallest gaps is singular
    to within its 1e-12 jitter: there two LAPACK factors of Q's that agree
    to 1e-14 differ by 5e-7, and the draw with them."""
    from stheno_tpu.markov import _discretise as jdiscretise
    from stheno_tpu.markov import markov_gp_logpdf, markov_gp_posterior_marginals
    from stheno_tpu_torch.markov import _discretise

    J, T = jax_example("markov_time_series"), port_example("markov_time_series")
    n = 2000
    x = np.sort(np.random.default_rng(0).uniform(0.0, 400.0, n))
    logp = np.log([1.5, 8.0, 0.4, 0.5])
    key = jax.random.PRNGKey(0)
    jk = J["make_kernel"](jnp.asarray(logp))
    A, Q, H, Pinf = jdiscretise(jk, jnp.asarray(x), jnp.float64)
    tA, tQ, tH = _discretise(T.make_kernel(t(logp)), t(x), F64)
    close(tA, A, atol=1e-12)
    close(tQ, Q, atol=1e-12 * float(jnp.abs(Q).max()))
    close(tH, H)
    L = jnp.linalg.cholesky(Q + 1e-12 * jnp.trace(Pinf) * jnp.eye(Pinf.shape[0])[None])
    want = np.asarray(J["_sample_markov"](jk, jnp.asarray(x), 0.1, key))
    zs = np.asarray(jax.random.normal(key, (n, Pinf.shape[0]), jnp.float64))
    eps_y = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (n,), jnp.float64))
    got = T.propagate(t(A), t(L), t(H), t(zs), t(eps_y), 0.1)
    close(got, want, atol=RTOL * float(np.abs(want).max()))

    start = np.log([1.0, 3.0, 1.0, 1.5])
    jv, jg = jax.jit(jax.value_and_grad(
        lambda lp: -markov_gp_logpdf(J["make_kernel"](lp), jnp.asarray(x), jnp.asarray(want), 0.1) / n))(
        jnp.asarray(start))
    lp = t(start).requires_grad_(True)
    tv = T.nlml(lp, t(x), t(want))
    (tg,) = torch.autograd.grad(tv, lp)
    close(tv, jv)
    close(tg, jg)

    xs = np.sort(np.random.default_rng(1).uniform(5.0, 395.0, 200))
    jm, jvar = jax.jit(lambda lp: markov_gp_posterior_marginals(
        J["make_kernel"](lp), jnp.asarray(x), jnp.asarray(want), 0.1, x_star=jnp.asarray(xs)))(
        jnp.asarray(start))
    tm, tvar = stt.markov_gp_posterior_marginals(T.make_kernel(t(start)), t(x), t(want), 0.1,
                                                 x_star=t(xs))
    close(tm, jm, atol=RTOL * float(np.abs(jm).max()))
    close(tvar, jvar)


def test_mlp_from_numpy_carries_flax_weights_into_the_deep_kernel():
    """flax's `FeatureNet` weights, carried by `mlp_from_numpy`, give the
    same features and the same nlml and gradient in (weights, v, noise)
    through the JAX `TransformedKernel` and the port's `ParamFn`, to 1e-12."""
    J, T = jax_example("deep_kernel_learning"), port_example("deep_kernel_learning")
    x, y = T.data(device="cpu")
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    net = J["FeatureNet"]()
    # flax makes f32 weights; the comparison is of f64 arithmetic on their values
    w_jax = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   net.init(jax.random.PRNGKey(0), jx))
    w = mlp_from_numpy(w_jax, device="cpu")
    assert set(w) == {f"Dense_{i}.{k}" for i in range(3) for k in ("weight", "bias")}
    close(T.apply(w, x), np.asarray(net.apply(w_jax, jx)), rtol=1e-12, atol=1e-12)

    def jnlml(wj, v, noise):
        k = v * st.TransformedKernel(st.SEKernel(), lambda xx: net.apply(wj, xx))
        f = st.GP(k, gpc=st.GPC())
        return -st.logpdf(f(jx, noise), jy)

    jv, (jgw, jgv, jgn) = jax.value_and_grad(jnlml, argnums=(0, 1, 2))(w_jax, 1.3, 0.2)
    p = {"w": {k: v.requires_grad_(True) for k, v in w.items()},
         "v": torch.tensor(1.3, dtype=F64, requires_grad=True),
         "noise": torch.tensor(0.2, dtype=F64, requires_grad=True)}
    tv = T.nlml(p, x, y)
    tg = dict(zip(["v", "noise", *p["w"]],
                  torch.autograd.grad(tv, [p["v"], p["noise"], *p["w"].values()])))
    close(tv, jv, rtol=1e-12)
    close(torch.stack([tg["v"], tg["noise"]]), np.asarray([jgv, jgn]), rtol=1e-12)
    want_w = mlp_from_numpy(jax.tree_util.tree_map(np.asarray, jgw), device="cpu")
    largest = max(float(g.abs().max()) for g in want_w.values())
    for k, g in want_w.items():
        close(tg[k], g, rtol=1e-12, atol=1e-12 * largest)

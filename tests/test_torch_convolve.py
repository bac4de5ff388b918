"""Quadrature convolutions of the port (`stheno_tpu_torch.graph.ConvolvedGP`,
`convolve_quadrature`) against `stheno_tpu`'s, in f64 on the CPU: every
statistic and the cross-covariances with the latent at rtol 1e-12, the
conformance checks, the deconvolution logpdf with its gradient and the
posterior of the latent given the convolved process, and the example
`quadrature_convolution.py` with its own checks (`entry`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as st
import stheno_tpu_torch as stt
from stheno_tpu.graph import convolve_quadrature as jax_convolve_quadrature
from stheno_tpu_torch import entry
from stheno_tpu_torch.utils.testing import check_process_interface
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

WIDTH = 0.5


def _window(xp):
    def w(x, tau):
        d = (x[:, None] - tau[None, :]) / WIDTH
        return xp.exp(-0.5 * d * d) / (WIDTH * np.sqrt(2.0 * np.pi))

    return w


def _programme(m, xp, name):
    """`(Cf, f)` of case `name`: f = GP(SE(·/0.4)) (plus a second atomic in
    "sum"), Cf its convolution on 241 nodes of [−6, 6] (trapezoid weights,
    or explicit ones in "deltas")."""
    nodes = np.linspace(-6.0, 6.0, 241)
    arr = jnp.asarray if xp is jnp else torch.as_tensor
    with m.GPC():
        f = m.GP(m.with_lengthscale(m.SEKernel(), 0.4))
        conv = jax_convolve_quadrature if m is st else stt.convolve_quadrature
        if name == "trapezoid":
            Cf = conv(f, _window(xp), arr(nodes))
        elif name == "deltas":
            Cf = conv(f, _window(xp), arr(nodes), arr(np.full(241, 0.05)))
        elif name == "sum":
            g = m.GP(0.3 * m.Matern52Kernel())
            Cf = conv(f + g, _window(xp), arr(nodes)) + 2.0 * f
        else:
            raise KeyError(name)
    return Cf, f


def _stats(m, h, f, x, x2, x3):
    return {
        "mean": h.mean(x), "cov": h.cov(x), "cov2": h.cov2(x, x2), "var": h.var(x),
        "var2": h.var2(x, x3),
        "cross_cov_hf": m.cross_cov(h, f, x, x2), "cross_cov_fh": m.cross_cov(f, h, x2, x),
        "cross_var_hf": m.cross_var(h, f, x, x3), "cross_var_fh": m.cross_var(f, h, x3, x),
    }


def _inputs():
    rng = np.random.default_rng(1)
    return rng.uniform(-3, 3, 11), rng.uniform(-3, 3, 7), rng.uniform(-3, 3, 11)


@pytest.mark.parametrize("name", ["trapezoid", "deltas", "sum"])
def test_convolved_statistics_match_reference(name):
    x, x2, x3 = _inputs()
    jprog = _programme(st, jnp, name)
    jstats = jax.jit(lambda *a: _stats(st, *jprog, *a))(*(jnp.asarray(a) for a in (x, x2, x3)))
    tstats = _stats(stt, *_programme(stt, torch, name), *(torch.as_tensor(a) for a in (x, x2, x3)))
    for k, want in jstats.items():
        np.testing.assert_allclose(tstats[k].detach().numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-13, err_msg=k)


@pytest.mark.parametrize("name", ["trapezoid", "sum"])
def test_convolved_process_passes_the_conformance_checks(name):
    Cf, f = _programme(stt, torch, name)
    x, x2, x3 = (torch.as_tensor(a) for a in _inputs())
    check_process_interface(Cf, x, x3, x2, f2=f, atol=1e-8)


def test_default_deltas_are_the_trapezoid_weights():
    Cf, _ = _programme(stt, torch, "trapezoid")
    jCf, _ = _programme(st, jnp, "trapezoid")
    np.testing.assert_array_equal(Cf.deltas.numpy(), np.asarray(jCf.deltas))
    with stt.GPC():
        with pytest.raises(ValueError):
            stt.convolve_quadrature(stt.GP(stt.SEKernel()), _window(torch),
                                    torch.zeros(5, 2))


@jax.jit
def _jax_deconvolution(theta, nodes, x, y, xp):
    @st.gppp
    def build(p):
        f = st.GP(p["v"] * st.with_lengthscale(st.SEKernel(), p["l"]))
        return dict(f=f, Cf=jax_convolve_quadrature(f, _window(jnp), nodes))

    def nlml(t):
        return -st.logpdf(build(t)(st.GPPPInput("Cf", x), t["noise"]), y)

    val, grad = jax.value_and_grad(nlml)(theta)
    post = st.posterior(build(theta)(st.GPPPInput("Cf", x), theta["noise"]), y)
    ms = st.marginals(post(st.BlockData(st.GPPPInput("f", xp), st.GPPPInput("Cf", xp)), 1e-9))
    return val, grad, ms


def test_deconvolution_step_and_posterior_match_reference():
    """The entry points' −logpdf of Cf, its gradient in (v, l, noise), and
    the posterior marginals of f and Cf given Cf, at N = 300 on 160 nodes."""
    x, y, xp, theta = entry.deconvolution_data(300, 32, 160, torch.float64, "cpu", seed=2)
    jt = {k: jnp.asarray(v.numpy()) for k, v in theta.items() if k != "nodes"}
    jval, jgrad, jms = _jax_deconvolution(jt, jnp.asarray(theta["nodes"].numpy()),
                                          *(jnp.asarray(a.numpy()) for a in (x, y, xp)))
    val, grad = entry.deconvolution_step(theta, (x, y, xp))
    ms = entry.deconvolution_predict(theta, (x, y, xp), noise=1e-9)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-10)
    for k in ("v", "l", "noise"):
        np.testing.assert_allclose(grad[k].item(), float(jgrad[k]), rtol=1e-8, err_msg=k)
    np.testing.assert_allclose(ms.mean.numpy(), np.asarray(jms.mean), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(ms.var.numpy(), np.asarray(jms.var), rtol=1e-8, atol=1e-9)


def test_quadrature_convolution_example_runs_with_its_checks():
    out = entry.quadrature_convolution_example(device="cpu")
    assert out["cov_err"] < 5e-4 and out["curv_cf"] < out["curv_f"]

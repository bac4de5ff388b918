"""The port's Neural Kernel Network (`stheno_tpu_torch.kernels.nkn`)
against `stheno_tpu`'s, in f64 on the CPU, given the same layer weights
(`convert.nkn_layers_from_numpy`): `matrix`, `matrix_same`, `diag` and
`diag_same` at rtol 1e-12, the explicit-algebra identities, the logpdf and
its gradient in the flat θ of the example's spec (primitive
hyperparameters constrained, the layers' log-weights raw), a few `fit`
steps, and the example's own run with its checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as st
import stheno_tpu_torch as stt
from stheno_tpu import params as JP
from stheno_tpu.inference import fit as jax_fit
from stheno_tpu_torch import entry
from stheno_tpu_torch import params as P
from stheno_tpu_torch.convert import nkn_layers_from_numpy
from stheno_tpu_torch.inference import fit
from stheno_tpu_torch.utils.testing import check_process_interface
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _jax_layers():
    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(1), 3)
    return (st.LinearLayer.init(k0, 4, 4), st.ProductLayer(), st.LinearLayer.init(k1, 2, 2),
            st.ProductLayer(), st.LinearLayer.init(k2, 1, 1, bias=False))


def _primitives(m, arr):
    return (m.SEKernel(), m.with_lengthscale(m.Matern52Kernel(), 0.7),
            m.with_lengthscale(m.LinearKernel(), 2.0), m.PeriodicKernel(r=arr(1.3)))


def _pair():
    jl = _jax_layers()
    jk = st.NeuralKernelNetwork(_primitives(st, jnp.asarray), jl)
    tk = stt.NeuralKernelNetwork(_primitives(stt, lambda v: torch.tensor(v, dtype=torch.float64)),
                                 nkn_layers_from_numpy(jl, torch.float64, "cpu"))
    return jk, tk


def test_nkn_matrices_match_reference():
    jk, tk = _pair()
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=9), rng.normal(size=6)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.as_tensor(x), torch.as_tensor(y)
    want = jax.jit(lambda a, b: (st.kernelmatrix(jk, a, b), st.kernelmatrix(jk, a),
                                 st.kernelmatrix_diag(jk, a, a[::-1]),
                                 st.kernelmatrix_diag(jk, a)))(jx, jy)
    got = (stt.kernelmatrix(tk, tx, ty), stt.kernelmatrix(tk, tx),
           stt.kernelmatrix_diag(tk, tx, tx.flip(0)), stt.kernelmatrix_diag(tk, tx))
    for want, got in zip(want, got):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


def test_nkn_layers_are_the_explicit_kernel_algebra():
    """A bias-free LinearLayer is a weighted kernel sum; a ProductLayer a
    kernel product; the last width must be 1."""
    x = torch.as_tensor(np.random.default_rng(1).normal(size=7))
    k1, k2 = stt.SEKernel(), stt.Matern32Kernel()
    w = torch.tensor([[0.3, 1.7]], dtype=torch.float64)
    nkn = stt.NeuralKernelNetwork((k1, k2), (stt.LinearLayer(torch.log(w)),))
    np.testing.assert_allclose(stt.kernelmatrix(nkn, x).numpy(),
                               stt.kernelmatrix(0.3 * k1 + 1.7 * k2, x).numpy(), atol=1e-12)
    unit = stt.LinearLayer(torch.zeros(1, 1, dtype=torch.float64))
    prod = stt.NeuralKernelNetwork((k1, k2), (stt.ProductLayer(), unit))
    np.testing.assert_allclose(stt.kernelmatrix(prod, x, x[:3]).numpy(),
                               stt.kernelmatrix(k1 * k2, x, x[:3]).numpy(), atol=1e-12)
    with pytest.raises(ValueError):
        stt.kernelmatrix(stt.NeuralKernelNetwork((k1, k2), ()), x)
    with pytest.raises(ValueError):
        stt.ProductLayer(3)(torch.ones(2, 4))


def test_nkn_gp_passes_the_conformance_checks():
    _, tk = _pair()
    with stt.GPC():
        f = stt.GP(tk)
    rng = np.random.default_rng(2)
    check_process_interface(f, *(torch.as_tensor(rng.normal(size=n)) for n in (7, 7, 5)))


def test_linear_layer_init_draws_from_the_generator():
    gen = torch.Generator().manual_seed(3)
    a = stt.LinearLayer.init(gen, 8, 4)
    b = stt.LinearLayer.init(torch.Generator().manual_seed(3), 8, 4)
    assert a.log_w.shape == (4, 8) and a.log_b.shape == (4,)
    torch.testing.assert_close(a.log_w, b.log_w, rtol=0, atol=0)
    np.testing.assert_allclose(a.log_w.mean().item(), -np.log(8.0), atol=0.1)
    assert stt.LinearLayer.init(gen, 2, 1, bias=False).log_b is None


def _spec(m, x_train, period, layers):
    """The example's spec in package `m` with the given layers."""
    xs = np.asarray(x_train)
    n = len(xs)
    l = float(np.median(np.abs(np.subtract.outer(xs, xs))[np.triu_indices(n, 1)]))  # noqa: E741
    pos = (JP.positive if m is st else lambda v, lb=0.0: P.positive(
        torch.tensor(v, dtype=torch.float64), lb=lb))
    return dict(
        l_lin1=pos(1.0), l_lin2=pos(3.0), p_per1=pos(period), r_per1=pos(1.0),
        p_per2=pos(period), r_per2=pos(0.7), l_se1=pos(l / 4.0), l_se2=pos(l),
        a_rq1=pos(0.2), l_rq1=pos(2.0 * l), a_rq2=pos(0.1), l_rq2=pos(l),
        layers=layers, noise=pos(0.1, lb=1e-4),
    )


def _jax_example_layers():
    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(0), 3)
    return (st.LinearLayer.init(k0, 8, 8), st.ProductLayer(), st.LinearLayer.init(k1, 4, 4),
            st.ProductLayer(), st.LinearLayer.init(k2, 2, 1))


def _jax_nlml(x, y):
    @st.gppp
    def build(p):
        prims = (
            st.with_lengthscale(st.LinearKernel(), p["l_lin1"]),
            st.with_lengthscale(st.PeriodicKernel(r=p["r_per1"]), p["p_per1"]),
            st.with_lengthscale(st.SEKernel(), p["l_se1"]),
            st.with_lengthscale(st.RationalQuadraticKernel(alpha=p["a_rq1"]), p["l_rq1"]),
            st.with_lengthscale(st.LinearKernel(), p["l_lin2"]),
            st.with_lengthscale(st.RationalQuadraticKernel(alpha=p["a_rq2"]), p["l_rq2"]),
            st.with_lengthscale(st.SEKernel(), p["l_se2"]),
            st.with_lengthscale(st.PeriodicKernel(r=p["r_per2"]), p["p_per2"]),
        )
        return dict(f=st.GP(st.NeuralKernelNetwork(prims, tuple(p["layers"]))))

    return lambda p: -st.logpdf(build(p)(st.GPPPInput("f", x), p["noise"]), y)


def test_nkn_logpdf_gradient_and_fit_match_reference():
    """The example's model on its first 60 training months: the flat θ of
    the spec (same order in both packages), −logpdf and its gradient at θ0
    (rtol 1e-10), and 3 Adam steps (losses rtol 1e-8)."""
    x, y, n_train, period = entry.nkn_data(dtype=torch.float64, device="cpu")
    x, y = x[:60], y[:60]
    jl = _jax_example_layers()
    jspec = _spec(st, x.numpy(), period, jl)
    tspec = _spec(stt, x.numpy(), period, nkn_layers_from_numpy(jl, torch.float64, "cpu"))
    jnlml = _jax_nlml(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    jtheta, junflat = JP.init(jspec)
    theta, _ = P.init(tspec)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta), rtol=0, atol=0)
    jval, jgrad = jax.jit(jax.value_and_grad(lambda t: jnlml(junflat(t))))(jtheta)
    val, grad = entry.nkn_step(theta, x, y, tspec)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-10)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-8, atol=1e-10)

    jres = jax_fit(jnlml, jspec, num_steps=3, learning_rate=2e-2)
    res = fit(lambda p: entry.nkn_nlml(p, x, y), tspec, num_steps=3, learning_rate=2e-2)
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(jres.losses), rtol=1e-8)


def test_nkn_example_runs_with_its_checks():
    """The example's `--fast` run (144 months, 120 Adam steps, f64): the
    loss falls, training RMSE < 0.25, extrapolation beats a linear trend."""
    out = entry.nkn_example(num_steps=120, device="cpu")
    assert out["loss_last"] < out["loss_first"] and out["rmse_train"] < 0.25

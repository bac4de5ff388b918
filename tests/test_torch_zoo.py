"""The rest of the kernel zoo (`stheno_tpu_torch.kernels.zoo`: RationalQuadratic,
GammaExponential, Cosine, Periodic, White, Constant, Zero, Linear,
Polynomial, Exponentiated, Wiener, FBM and NeuralNetwork) against
`stheno_tpu.kernels.zoo`, in f64 on the CPU: the same numpy-seeded inputs
and hyperparameters through both packages' `matrix`, `matrix_same`, `diag`
and `diag_same` (rtol 1e-12), and `logpdf` with its gradient through
`GP(k)(x, σ²)` (rtol 1e-9), which also holds each `matrix` to the rule that
the noise may be added into it in place."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as st
import stheno_tpu_torch as stt
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _ls(m, k, p):
    return m.with_lengthscale(k, p["ell"])


#: name → (a function making the kernel from a package `m` and its parameters `p`,
#: the parameters, the input dimension, the input scale)
ZOO = {
    "rational_quadratic": (lambda m, p: _ls(m, m.RationalQuadraticKernel(p["alpha"]), p),
                           {"alpha": 1.3, "ell": 0.8}, 2, 1.0),
    "gamma_exponential": (lambda m, p: _ls(m, m.GammaExponentialKernel(p["gamma"]), p),
                          {"gamma": 1.5, "ell": 1.1}, 2, 1.0),
    "cosine": (lambda m, p: _ls(m, m.CosineKernel(), p), {"ell": 3.0}, 1, 1.0),
    "periodic": (lambda m, p: m.PeriodicKernel(p["r"]), {"r": [0.8, 1.2]}, 2, 1.0),
    "white": (lambda m, p: m.WhiteKernel(), {}, 2, 1.0),
    "constant": (lambda m, p: m.ConstantKernel(p["c"]), {"c": 1.7}, 2, 1.0),
    "zero": (lambda m, p: m.ZeroKernel(), {}, 2, 1.0),
    "linear": (lambda m, p: m.LinearKernel(p["c"]), {"c": 0.4}, 2, 1.0),
    "polynomial": (lambda m, p: m.PolynomialKernel(p["c"], degree=3), {"c": 0.5}, 2, 1.0),
    "exponentiated": (lambda m, p: m.ExponentiatedKernel(), {}, 2, 0.3),
    "wiener": (lambda m, p: m.WienerKernel(), {}, 1, 1.0),
    "fbm": (lambda m, p: m.FBMKernel(p["h"]), {"h": 0.3}, 2, 1.0),
    "neural_network": (lambda m, p: m.NeuralNetworkKernel(), {}, 2, 1.0),
}


def _inputs(name, seed, n):
    _, _, dim, scale = ZOO[name]
    rng = np.random.default_rng(seed)
    shape = (n, dim) if dim > 1 else (n,)
    x = scale * rng.normal(size=shape)
    if name == "wiener":  # Brownian motion lives on x ≥ 0
        x = np.abs(x)
    return x


def _pair(name, jparams=None, tparams=None):
    build, p, _, _ = ZOO[name]
    jp = jparams or {k: jnp.asarray(v) for k, v in p.items()}
    tp = tparams or {k: torch.tensor(v, dtype=torch.float64) for k, v in p.items()}
    return build(st, jp), build(stt, tp)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_matrix_and_diag_match_reference(name):
    jk, tk = _pair(name)
    x, y = _inputs(name, 0, 23), _inputs(name, 1, 23)
    if name == "white":  # equal points give ones off the diagonal
        y[::3] = x[::3]
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.as_tensor(x), torch.as_tensor(y)
    y_short = _inputs(name, 2, 9)
    jys, tys = jnp.asarray(y_short), torch.as_tensor(y_short)
    for got, want, what in (
        (tk.matrix(tx, tys), jk.matrix(jx, jys), "matrix"),
        (stt.kernelmatrix(tk, tx), st.kernelmatrix(jk, jx), "matrix_same"),
        (stt.kernelmatrix_diag(tk, tx, ty), st.kernelmatrix_diag(jk, jx, jy), "diag"),
        (stt.kernelmatrix_diag(tk, tx), st.kernelmatrix_diag(jk, jx), "diag_same"),
    ):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float64, what
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14, err_msg=what)
    # a fresh, dense matrix: the noise may be added into it in place
    K = stt.kernelmatrix(tk, tx)
    assert K.is_contiguous() and K.stride() == (K.shape[1], 1)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_logpdf_and_gradient_match_reference(name):
    _, p, _, _ = ZOO[name]
    rng = np.random.default_rng(3)
    x = _inputs(name, 4, 31)
    y = rng.normal(size=31)
    sigma2 = 0.3

    def jnlml(jp):
        jk, _ = _pair(name, jparams={k: v for k, v in jp.items() if k != "s2"})
        with st.GPC():
            f = st.GP(jk)
        return -st.logpdf(f(jnp.asarray(x), jp["s2"]), jnp.asarray(y))

    jp = {k: jnp.asarray(v) for k, v in p.items()} | {"s2": jnp.asarray(sigma2)}
    jval, jgrad = jax.value_and_grad(jnlml)(jp)

    tp = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True) for k, v in p.items()}
    s2 = torch.tensor(sigma2, dtype=torch.float64, requires_grad=True)
    _, tk = _pair(name, tparams=tp)
    with stt.GPC():
        f = stt.GP(tk)
    val = -stt.logpdf(f(torch.as_tensor(x), s2), torch.as_tensor(y))
    leaves = list(tp.values()) + [s2]
    grads = torch.autograd.grad(val, leaves)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-9)
    for k, g in zip(list(tp) + ["s2"], grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[k]), rtol=1e-9, atol=1e-12,
                                   err_msg=k)


def test_exp_saves_its_input_not_its_output():
    """The zoo's exp may be added into in place and still differentiates."""
    t = torch.linspace(-1.0, 1.0, 5, dtype=torch.float64, requires_grad=True)
    out = stt.kernels.zoo._exp(t)
    out.add_(1.0)
    (g,) = torch.autograd.grad(out.sum(), t)
    np.testing.assert_allclose(g.numpy(), np.exp(t.detach().numpy()), rtol=1e-15)

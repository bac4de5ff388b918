"""Pathwise sampling of the port (`stheno_tpu_torch.sampling`) against
`stheno_tpu.sampling`, in f64 on the CPU.

- Deterministic: given the reference's own draws (ω, phases, weights,
  carried across by `convert.fourier_basis_from_numpy`, and its noise
  draws), the bases, the prior paths of a composite programme (sums,
  scalings, warps, derivatives, convolutions, `BlockData`) and the
  Matheron-updated posterior paths equal the reference's to 1e-12
  (posterior paths 1e-10: two Cholesky factors).
- Statistical, mirroring `tests/test_sampling.py` at its sizes and limits:
  the features against the kernel, the joint prior covariance, pathwise
  draws against the exact posterior (observed and latent process), one
  coherent function, derivative sample paths.
- Unsupported kernels and nodes raise as the reference's do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as st
from stheno_tpu import sampling as js
from stheno_tpu.graph import convolve_quadrature as jax_convolve_quadrature
from stheno_tpu.kernels.base import TransformedKernel as JTransformedKernel

import stheno_tpu_torch as stt
from stheno_tpu_torch import sampling as ts
from stheno_tpu_torch.convert import fourier_basis_from_numpy
from stheno_tpu_torch.kernels.base import TransformedKernel
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

F64 = torch.float64


def _kernels(m, sin):
    """The reference test's kernels, in package `m` (`sin` its sine)."""
    return [
        m.SEKernel(), m.Matern12Kernel(), m.Matern32Kernel(), m.Matern52Kernel(),
        m.RationalQuadraticKernel(alpha=1.7),
        2.3 * m.with_lengthscale(m.SEKernel(), 0.7),
        m.with_lengthscale(m.Matern32Kernel(), 1.4),
        m.SEKernel() + 0.5 * m.Matern52Kernel(),
        m.SEKernel() * m.Matern12Kernel(),
        # a lengthscale over a non-linear input transform divides the input
        m.with_lengthscale((JTransformedKernel if m is st else TransformedKernel)(m.SEKernel(),
                                                                                  sin), 0.6),
    ]


JAX_KERNELS = _kernels(st, jnp.sin)
TORCH_KERNELS = _kernels(stt, torch.sin)


@pytest.mark.parametrize("ki", range(len(JAX_KERNELS)))
def test_basis_given_the_reference_draws_matches(ki):
    """The reference's basis of each kernel, evaluated by both packages."""
    jb = js.spectral_features(JAX_KERNELS[ki], jax.random.PRNGKey(ki), 64)
    tf = None if jb.transform is None else (lambda x: torch.sin(torch.as_tensor(x) / 0.6))
    tb = fourier_basis_from_numpy(jb, tf, F64, "cpu")
    x = np.linspace(-2.0, 2.0, 9)
    np.testing.assert_allclose(tb(torch.as_tensor(x)).numpy(), np.asarray(jb(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-14)
    # the port's own draw has the same structure
    ob = ts.spectral_features(TORCH_KERNELS[ki], 0, 64, dtype=F64)
    assert ob.omega.shape == (64, 1) and (ob.transform is None) == (jb.transform is None)
    np.testing.assert_allclose(ob.scale.numpy(), np.asarray(jb.scale), rtol=1e-12)


def _programme(m):
    """f1 + stretch(f2), a derivative and a convolution of f1, in `m`."""
    xp = jnp if m is st else torch
    nodes = np.linspace(-4.0, 4.0, 81)

    def w(x, tau):
        d = (x[:, None] - tau[None, :]) / 0.5
        return xp.exp(-0.5 * d * d)

    @m.gppp
    def build(t):
        f1 = m.GP(m.with_lengthscale(m.SEKernel(), 1.2))
        f2 = m.GP(0.5 * m.Matern32Kernel())
        conv = jax_convolve_quadrature if m is st else stt.convolve_quadrature
        return dict(f1=f1, f2=f2, f3=f1 + m.stretch(f2, 2.0), df1=m.derivative(f1),
                    cf1=conv(f1, w, xp.asarray(nodes) if m is st else torch.as_tensor(nodes)),
                    g=1.5 * f2 + 0.3)

    return build({})


def _port_prior(jprior, tprog):
    """The port's prior paths holding the reference prior's draws."""
    leaves = {}
    ts._collect_atomics(tprog, leaves)
    draws = {n: (fourier_basis_from_numpy(b, None, F64, "cpu"), torch.tensor(np.asarray(w)),
                 leaves[n].mean) for n, (b, w, _) in jprior._leaf.items()}
    return ts.PriorFunctionSamples(tprog, draws, jprior.num_samples)


def _query(m, tag_x):
    return m.BlockData(*(m.GPPPInput(t, x) for t, x in tag_x))


def test_prior_paths_given_the_reference_draws_match():
    jprog, tprog = _programme(st), _programme(stt)
    jprior = js.prior_samples(jprog, jax.random.PRNGKey(3), 5, num_features=128)
    tprior = _port_prior(jprior, tprog)
    x = np.linspace(-2.0, 2.0, 7)
    tags = ("f1", "f2", "f3", "df1", "cf1", "g")
    want = jprior(_query(st, [(t, jnp.asarray(x)) for t in tags]))
    got = tprior(_query(stt, [(t, torch.as_tensor(x)) for t in tags]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("noise", ["diag", "full"])
def test_posterior_paths_given_the_reference_draws_match(noise):
    """Matheron's update of the reference's prior draws with its noise
    draws (its key split as `pathwise_conditioned_samples` splits it),
    against the reference's paths built from its own covariance, cross
    covariance and prior paths.  With diagonal noise that is the
    reference's `pathwise_conditioned_samples` itself; with a full noise
    matrix the reference raises (it reads `FullNoise.cov`, which does not
    exist: ROADMAP §C), and the port samples."""
    from stheno_tpu.finite_gp import _cross_cov_any

    jprog, tprog = _programme(st), _programme(stt)
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-3, 3, 30))
    y = np.sin(x)
    S_noise = 0.05 * np.eye(30) + 0.01 * np.exp(-np.subtract.outer(x, x) ** 2)
    nz = np.asarray(0.05) if noise == "diag" else S_noise
    jfx = jprog(st.GPPPInput("f3", jnp.asarray(x)), jnp.asarray(nz))
    tfx = tprog(stt.GPPPInput("f3", torch.as_tensor(x)), torch.as_tensor(nz))
    key = jax.random.PRNGKey(5)
    k_prior, k_eps = jax.random.split(key)
    jprior = js.prior_samples(jfx.f, k_prior, 4, 128)
    if noise == "diag":
        eps = np.sqrt(0.05) * np.asarray(jax.random.normal(k_eps, (4, 30), jnp.float64))
        jpost = js.pathwise_conditioned_samples(jfx, jnp.asarray(y), key, 4, num_features=128)
    else:
        Ln = np.linalg.cholesky(S_noise)
        eps = (Ln @ np.asarray(jax.random.normal(k_eps, (30, 4), jnp.float64))).T
        with pytest.raises(AttributeError):
            js.pathwise_conditioned_samples(jfx, jnp.asarray(y), key, 4, num_features=128)
    V = np.linalg.solve(np.asarray(jfx.cov()), (y[None, :] - np.asarray(jprior(jfx.x)) - eps).T)
    tprior = _port_prior(jprior, tprog)
    tpost = ts._condition(tprior, tfx, torch.as_tensor(y), tprior(tfx.x), torch.as_tensor(eps))
    xq = np.linspace(-2.5, 2.5, 11)
    for tag in ("f3", "f1", "df1"):
        jq = st.GPPPInput(tag, jnp.asarray(xq))
        want = np.asarray(jprior(jq)) + V.T @ np.asarray(_cross_cov_any(jfx.f, jfx.x, jfx.f, jq))
        got = tpost(stt.GPPPInput(tag, torch.as_tensor(xq))).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10, err_msg=tag)
        if noise == "diag":
            np.testing.assert_allclose(got, np.asarray(jpost(jq)), rtol=1e-10, atol=1e-10,
                                       err_msg=tag)


@pytest.mark.parametrize("ki", range(len(TORCH_KERNELS)))
def test_rff_basis_approximates_kernel(ki):
    """The mean of φφᵀ over R = 8 independent bases of F = 4096 features
    is within 0.05 of K (the reference's sizes and limit)."""
    k = TORCH_KERNELS[ki]
    x = torch.linspace(-2.0, 2.0, 25, dtype=F64)
    K = stt.kernelmatrix(k, x)
    rng = np.random.default_rng(ki)
    acc = sum(phi @ phi.T for phi in (ts.spectral_features(k, rng, 4096, dtype=F64)(x)
                                      for _ in range(8)))
    err = (acc / 8 - K).abs().max().item()
    assert err < 0.05, (type(k).__name__, err)


def test_prior_samples_match_the_joint_covariance():
    """Functional draws of f3 = f1 + stretch(f2) and f1 (S = 60000,
    F = 2048): empirical covariance within 0.08 of the graph's joint
    covariance, cross block included, means within 0.05."""

    @stt.gppp
    def build(t):
        f1 = stt.GP(stt.with_lengthscale(stt.SEKernel(), 1.2))
        f2 = stt.GP(0.5 * stt.Matern32Kernel())
        return dict(f1=f1, f2=f2, f3=f1 + stt.stretch(f2, 2.0))

    prog = build({})
    x = torch.linspace(-2.0, 2.0, 20, dtype=F64)
    draws = stt.prior_samples(prog, 1, 60000, num_features=2048, dtype=F64)
    xs = stt.BlockData(stt.GPPPInput("f3", x), stt.GPPPInput("f1", x))
    Y = draws(xs).numpy()
    K = prog.cov(xs).numpy()
    assert np.max(np.abs(np.cov(Y.T) - K)) < 0.08
    assert np.max(np.abs(Y.mean(0))) < 0.05


def test_pathwise_posterior_matches_exact():
    """Conditioned paths (S = 20000, F = 4096): empirical mean within 0.05
    and variance within 0.08 of the exact posterior's, on the observed
    process and on a latent one."""

    @stt.gppp
    def build(t):
        f1 = stt.GP(stt.with_lengthscale(stt.SEKernel(), 1.0))
        f2 = stt.GP(0.4 * stt.Matern32Kernel())
        return dict(f1=f1, f2=f2, f3=f1 + f2)

    prog = build({})
    x = torch.as_tensor(np.sort(np.random.default_rng(0).uniform(-3, 3, 40)))
    fx = prog(stt.GPPPInput("f3", x), 0.05)
    samp = stt.pathwise_conditioned_samples(fx, torch.sin(x), 2, 20000, num_features=4096)
    post = stt.posterior(fx, torch.sin(x))
    for tag in ("f3", "f1"):
        xs = stt.GPPPInput(tag, torch.linspace(-2.5, 2.5, 15, dtype=F64))
        Y = samp(xs).numpy()
        assert np.max(np.abs(Y.mean(0) - post.mean(xs).numpy())) < 0.05, tag
        assert np.max(np.abs(Y.var(0) - post.var(xs).numpy())) < 0.08, tag


def test_pathwise_sample_is_one_coherent_function():
    """The same draw at overlapping inputs agrees pointwise; one seed gives
    the same draws again."""
    with stt.GPC():
        f = stt.GP(stt.SEKernel())
    x = torch.linspace(-2, 2, 30, dtype=F64)
    samp = stt.pathwise_conditioned_samples(f(x, 0.1), torch.sin(x), 3, 3, num_features=256)
    a = samp(torch.linspace(-1, 1, 9, dtype=F64)).numpy()
    b = samp(torch.linspace(-1, 1, 17, dtype=F64)).numpy()[:, ::2]
    np.testing.assert_allclose(a, b, atol=1e-10)
    again = stt.pathwise_conditioned_samples(f(x, 0.1), torch.sin(x), 3, 3, num_features=256)
    np.testing.assert_array_equal(again(torch.linspace(-1, 1, 9, dtype=F64)).numpy(), a)


def test_derivative_sample_paths():
    """The derivative of the RFF path is exact: the empirical covariance of
    sampled f′ (S = 60000, F = 2048) within 0.08 of DerivativeGP's."""
    with stt.GPC():
        f = stt.GP(stt.with_lengthscale(stt.SEKernel(), 1.3))
        df = stt.derivative(f)
    x = torch.linspace(-1.5, 1.5, 12, dtype=F64)
    Y = stt.prior_samples(df, 4, 60000, num_features=2048, dtype=F64)(x).numpy()
    assert np.max(np.abs(np.cov(Y.T) - df.cov(x).numpy())) < 0.08


def test_unsupported_kernels_and_nodes_raise():
    with pytest.raises(NotImplementedError):
        ts.spectral_features(stt.LinearKernel(), 0, 64)
    with pytest.raises(NotImplementedError):
        ts.spectral_features(stt.CosineKernel(), 0, 64, input_dim=2)
    with pytest.raises(NotImplementedError):
        ts.spectral_features(TransformedKernel(stt.SEKernel(), torch.sin) + stt.SEKernel(), 0, 64)
    with pytest.raises(NotImplementedError):
        ts.spectral_features(TransformedKernel(stt.SEKernel(), torch.sin) * stt.SEKernel(), 0, 64)
    with stt.GPC() as gpc:
        w = stt.atomic(stt.GP(stt.SEKernel()) + stt.GP(stt.SEKernel()), gpc)
        with pytest.raises(NotImplementedError):
            stt.prior_samples(w, 0, 2)
    with pytest.raises(NotImplementedError):
        js.spectral_features(st.LinearKernel(), jax.random.PRNGKey(0), 64)

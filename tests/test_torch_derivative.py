"""Derivative processes of the port (`stheno_tpu_torch.graph.DerivativeGP`,
`derivative`) against `stheno_tpu`'s, in f64 on the CPU, and kernel 1's
forward-mode rule (`_KernelMatrix.jvp`) against forward mode through the
kernel's plain version.

Inputs are made with numpy from a seed and fed to both packages.  Every
statistic of a derivative process (mean, cov, cov2, var, var2 and the
cross-covariances with the parent and a sibling) is held to the
reference's at rtol 1e-10 (atol 1e-12), at distinct inputs and at inputs
that coincide; the gradient-enhanced logpdf and its gradient likewise, by
the default route and under `chol_backend("blocked")` with a small
backward panel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu
import stheno_tpu as st
import stheno_tpu_torch as stt
from stheno_tpu_torch import entry
from stheno_tpu_torch.cuda.kernelmatrix import kernelmatrix, kernelmatrix_plain
from stheno_tpu_torch.utils.testing import check_process_interface
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

RTOL, ATOL = 1e-10, 1e-12


def _jvp_ones(fn, x):
    return torch.func.jvp(fn, (x,), (torch.ones_like(x),))[1]


def _programme(m, name):
    """`(h, f, g)`: the derivative process of case `name` of package `m`,
    its parent's atomic f, and an independent-looking sibling g that h may
    be correlated with."""
    with m.GPC():
        f = m.GP(m.SEKernel())
        g = m.GP(1.7 * m.with_lengthscale(m.Matern52Kernel(), 0.8))
        if name == "se":
            h = m.derivative(f)
        elif name == "matern52":
            h = m.derivative(g)
        elif name == "matern32":
            h = m.derivative(m.GP(m.with_lengthscale(m.Matern32Kernel(), 1.3)))
        elif name == "scaled_stretched":
            h = m.derivative(2.0 * m.stretch(f, 0.5))
        elif name == "sum":
            h = m.derivative(f + g)
        elif name == "second":
            h = m.derivative(m.derivative(f + 0.5 * g))
        elif name == "se_sum":
            h = m.derivative(f + m.GP(0.5 * m.with_lengthscale(m.SEKernel(), 0.7)))
        elif name == "second_se":
            h = m.derivative(m.derivative(2.0 * f))
        elif name == "rq_shifted":
            h = m.derivative(m.shift(m.GP(m.RationalQuadraticKernel(alpha=1.5)), 0.3) + f)
        else:
            raise KeyError(name)
    return h, f, g


CASES = ["se", "matern52", "matern32", "scaled_stretched", "sum", "second", "rq_shifted"]


def _inputs(coincide):
    rng = np.random.default_rng(0)
    x = rng.normal(size=9)
    x2 = rng.normal(size=7)
    x3 = rng.normal(size=9)
    if coincide:  # some points of x2 and x3 are points of x
        x2[:3], x3[::2] = x[:3], x[::2]
    return x, x2, x3


def _stats(m, h, f, g, x, x2, x3):
    return {
        "mean": h.mean(x), "cov": h.cov(x), "cov2": h.cov2(x, x2), "var": h.var(x),
        "var2": h.var2(x, x3),
        "cross_cov_hf": m.cross_cov(h, f, x, x2), "cross_cov_fh": m.cross_cov(f, h, x2, x),
        "cross_cov_hg": m.cross_cov(h, g, x, x2), "cross_var_hg": m.cross_var(h, g, x, x3),
        "cross_var_gh": m.cross_var(g, h, x3, x),
    }


@pytest.mark.parametrize("coincide", [False, True], ids=["distinct", "coincident"])
@pytest.mark.parametrize("name", CASES)
def test_derivative_statistics_match_reference(name, coincide):
    x, x2, x3 = _inputs(coincide)
    jprog = _programme(st, name)
    jstats = jax.jit(lambda *a: _stats(st, *jprog, *a))(*(jnp.asarray(a) for a in (x, x2, x3)))
    tstats = _stats(stt, *_programme(stt, name), *(torch.as_tensor(a) for a in (x, x2, x3)))
    for k, want in jstats.items():
        np.testing.assert_allclose(tstats[k].detach().numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_matern_derivative_is_zero_at_coincident_points_in_both_packages():
    """At x = y the masked square root of both packages has a zero tangent,
    so cov(f′, f′) of a Matern process is 0 there, not its limit (3 for
    Matern32, 5/3 for Matern52): a property of the reference that the port
    keeps (ROADMAP §C)."""
    x = np.array([0.3, -1.1])
    for kern, limit in ((st.Matern32Kernel, 3.0), (st.Matern52Kernel, 5.0 / 3.0)):
        with st.GPC():
            jdf = st.derivative(st.GP(kern()))
        with stt.GPC():
            tdf = stt.derivative(stt.GP(getattr(stt, kern.__name__)()))
        jK, tK = np.asarray(jdf.cov(jnp.asarray(x))), tdf.cov(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(tK, jK, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(np.diagonal(tK), 0.0)
        # beside the coincident point, the limit
        near = tdf.cov2(torch.as_tensor(x[:1]), torch.as_tensor(x[:1] + 1e-6)).item()
        np.testing.assert_allclose(near, limit, rtol=1e-5)


@pytest.mark.parametrize("name", ["se", "scaled_stretched", "se_sum", "second_se"])
def test_derivative_process_passes_the_conformance_checks(name):
    """The conformance suite on derivatives of SE processes (a Matern
    derivative's covariance is not PSD at coincident points, in either
    package: see the test above)."""
    h, f, _ = _programme(stt, name)
    x0, _, x2 = _inputs(False)
    check_process_interface(h, torch.as_tensor(x0), torch.as_tensor(x0[::-1] + 0.5),
                            torch.as_tensor(x2), f2=f)


def test_se_mixed_derivative_is_one_at_zero_distance():
    """∂²k/∂x_i∂y_i of SE at x = y is exactly 1 (`tests/test_graph.py:220-237`):
    through kernel 1's forward-mode rule, as the reference's clamp keeps
    its tangents."""
    x = torch.as_tensor(np.random.default_rng(42).normal(size=4))
    H = _jvp_ones(lambda a: _jvp_ones(lambda b: stt.kernelmatrix(stt.SEKernel(), a, b), x), x)
    np.testing.assert_allclose(np.diagonal(H.numpy()), np.ones(4), atol=1e-10)
    jx = jnp.asarray(x.numpy())
    jH = jax.jvp(lambda a: jax.jvp(lambda b: st.kernelmatrix(st.SEKernel(), a, b), (jx,),
                                   (jnp.ones_like(jx),))[1], (jx,), (jnp.ones_like(jx),))[1]
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["se", "matern12", "matern32", "matern52"])
@pytest.mark.parametrize("dim", [1, 2])
def test_kernelmatrix_jvp_rule_matches_forward_mode_through_the_plain_version(kind, dim):
    """The rule (through the Function) against torch's own forward mode over
    `kernelmatrix_plain`: first and nested tangents in x, y and σ², the
    same-input call and reverse mode over the nested tangent, at distinct
    and coincident points, to 1e-12."""
    rng = np.random.default_rng(dim)
    x = torch.as_tensor(rng.normal(size=(6, dim)))
    y = torch.cat([torch.as_tensor(rng.normal(size=(4, dim))), x[:2]])
    results = []
    for fn in (kernelmatrix, kernelmatrix_plain):
        v = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)

        def k(a, b, vv=v):
            return fn(a, b, kind, vv)

        first = _jvp_ones(lambda b: k(x, b), y)
        nested = _jvp_ones(lambda a: _jvp_ones(lambda b: k(a, b), y), x)
        in_v = _jvp_ones(lambda vv: _jvp_ones(lambda a: k(a, y, vv), x), v)
        same = _jvp_ones(lambda a: k(a, None), x)
        (g,) = torch.autograd.grad((nested**2).sum() + first.sum() + in_v.sum() + same.sum(), v)
        results.append([t.detach() for t in (first, nested, in_v, same, g)])
    for got, want in zip(*results):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def test_exp_function_nests_under_forward_mode():
    """`_Exp`'s forward-mode rule nests: ∂²eᵗ = eᵗ (the RQ, Periodic and
    GammaExponential kernels go through it)."""
    from stheno_tpu_torch.kernels.zoo import _exp

    t = torch.linspace(-1.0, 1.0, 5, dtype=torch.float64)
    np.testing.assert_allclose(_jvp_ones(lambda a: _jvp_ones(_exp, a), t).numpy(),
                               torch.exp(t).numpy(), rtol=1e-15)


def _jax_gradient_enhanced(theta, xf, xd, y):
    @st.gppp
    def build(p):
        f = st.GP(p["v"] * st.with_lengthscale(st.SEKernel(), p["l"]))
        return dict(f=f, df=st.derivative(f))

    def nlml(t):
        fx = build(t)(st.BlockData(st.GPPPInput("f", xf), st.GPPPInput("df", xd)), t["noise"])
        return -st.logpdf(fx, y)

    return jax.jit(jax.value_and_grad(nlml))(theta)


@pytest.mark.parametrize("route", ["default", "blocked"])
def test_gradient_enhanced_logpdf_and_gradient_match_reference(route):
    """−logpdf of f and f′ observed jointly and its gradient in (v, l,
    noise), the gradient reverse mode through the nested jvp of K_df,df."""
    n = 1200 if route == "blocked" else 120
    xf, xd, y, _, theta = entry.derivative_data(n, 8, torch.float64, "cpu", seed=3)
    jt = {k: jnp.asarray(v.numpy()) for k, v in theta.items()}
    jx = [jnp.asarray(a.numpy()) for a in (xf, xd, y)]
    if route == "blocked":
        scopes = (stheno_tpu.config.chol_backend("blocked"),
                  stheno_tpu.config.bwd_params(block=512),
                  stt.config.chol_backend("blocked"), stt.config.bwd_params(block=512))
    else:
        scopes = ()
    with _nested(scopes):
        jval, jgrad = _jax_gradient_enhanced(jt, *jx)
        val, grad = entry.derivative_step(theta, (xf, xd, y))
    np.testing.assert_allclose(val.item(), float(jval), rtol=RTOL)
    for k in ("v", "l", "noise"):
        np.testing.assert_allclose(grad[k].item(), float(jgrad[k]), rtol=1e-9, err_msg=k)


class _nested:
    """Enter several context managers in order."""

    def __init__(self, cms):
        self.cms = cms

    def __enter__(self):
        for cm in self.cms:
            cm.__enter__()

    def __exit__(self, *exc):
        for cm in reversed(self.cms):
            cm.__exit__(*exc)
        return False


def test_derivative_predict_matches_reference_posterior():
    """Posterior marginals of f, f′ and f″ given f and f′ observed jointly."""
    xf, xd, y, xp, theta = entry.derivative_data(200, 16, torch.float64, "cpu", seed=5)
    ms = entry.derivative_predict(theta, (xf, xd, y, xp), noise=1e-9)

    @st.gppp
    def build(p):
        f = st.GP(p["v"] * st.with_lengthscale(st.SEKernel(), p["l"]))
        df = st.derivative(f)
        return dict(f=f, df=df, ddf=st.derivative(df))

    jt = {k: jnp.asarray(v.numpy()) for k, v in theta.items()}
    jxf, jxd, jy, jxp = (jnp.asarray(a.numpy()) for a in (xf, xd, y, xp))
    @jax.jit
    def ref(t, xf_, xd_, y_, xp_):
        post = st.posterior(build(t)(st.BlockData(st.GPPPInput("f", xf_), st.GPPPInput("df", xd_)),
                                     t["noise"]), y_)
        q = st.BlockData(st.GPPPInput("f", xp_), st.GPPPInput("df", xp_), st.GPPPInput("ddf", xp_))
        return st.marginals(post(q, 1e-9))

    jm = ref(jt, jxf, jxd, jy, jxp)
    np.testing.assert_allclose(ms.mean.numpy(), np.asarray(jm.mean), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(ms.var.numpy(), np.asarray(jm.var), rtol=1e-8, atol=1e-9)

"""The port's slice as a whole against the JAX package: the flagship
`(-logpdf, gradient)` step against `__graft_entry__._flagship`, `predict`
against `stheno_tpu.posterior`, and the GPPP surface the slice rests on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu
import stheno_tpu as st
import stheno_tpu_torch as stt
from __graft_entry__ import _flagship
from stheno_tpu_torch import entry
from stheno_tpu_torch.convert import theta_from_numpy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-9), "f32": (jnp.float32, torch.float32, 1e-3)}


def _blocked_scopes(block):
    """Both packages on the blocked path, with a backward panel block small
    enough that n=2048 runs the panel sweep."""
    return (stheno_tpu.config.chol_backend("blocked"), stheno_tpu.config.bwd_params(block=block),
            stt.config.chol_backend("blocked"), stt.config.bwd_params(block=block))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [512, 2048])
def test_flagship_matches_reference(n, dtype):
    jdt, tdt, rtol = DTYPES[dtype]
    s1, s2, s3, s4 = _blocked_scopes(512)
    with s1, s2:
        jstep, jtheta = _flagship(jdt, n)
        jval, jgrad = jax.jit(jstep)(jtheta)
    with s3, s4:
        step, _ = entry.flagship(n, tdt, device="cpu")
        # the reference's own θ, carried across through numpy
        theta = theta_from_numpy({k: np.asarray(v) for k, v in jtheta.items()}, tdt, "cpu")
        val, grad = step(theta)
    np.testing.assert_allclose(val.item(), float(jval), rtol=rtol)
    for k in ("v1", "l1", "l2", "noise"):
        np.testing.assert_allclose(grad[k].item(), float(jgrad[k]), rtol=rtol, err_msg=k)


def test_flagship_torch_route_matches_reference_lax_route():
    """Outside the blocked scope both packages take their library Cholesky."""
    jstep, jtheta = _flagship(jnp.float64, 512)
    jval, jgrad = jax.jit(jstep)(jtheta)
    step, theta = entry.flagship(512, torch.float64, device="cpu")
    val, grad = step(theta)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-10)
    for k in grad:
        np.testing.assert_allclose(grad[k].item(), float(jgrad[k]), rtol=1e-9, err_msg=k)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [512, 2048])
def test_predict_matches_reference_posterior(n, dtype):
    jdt, tdt, rtol = DTYPES[dtype]
    x, y, xp, theta = entry.flagship_data(n, 256, tdt, device="cpu")
    s1, s2, s3, s4 = _blocked_scopes(4096)
    with s1, s2:
        jt = {k: jnp.asarray(v.numpy()) for k, v in theta.items()}
        jx, jy, jxp = (jnp.asarray(a.numpy()) for a in (x, y, xp))

        @st.gppp
        def build(p):
            f1 = st.GP(p["v1"] * st.with_lengthscale(st.SEKernel(), p["l1"]))
            f2 = st.GP(st.with_lengthscale(st.Matern32Kernel(), p["l2"]))
            return dict(f1=f1, f2=f2, f3=f1 + f2)

        @jax.jit
        def ref(t, xx, yy, xxp):
            post = st.posterior(build(t)(st.GPPPInput("f3", xx), t["noise"]), yy)
            return post(st.GPPPInput("f1", xxp)).mean_and_var()

        m_ref, v_ref = ref(jt, jx, jy, jxp)
    with s3, s4:
        m, v = entry.predict(theta, x, y, xp)
    m_ref, v_ref = np.asarray(m_ref), np.asarray(v_ref)
    np.testing.assert_allclose(m.numpy(), m_ref, rtol=rtol, atol=rtol * np.abs(m_ref).max())
    # the variance is a difference of O(v1) terms: hold it to v1's scale
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=rtol, atol=rtol * 1.5)


def _programme_pair():
    @st.gppp
    def jbuild():
        f1 = st.GP(st.SEKernel())
        f2 = st.GP(2.0 * st.with_lengthscale(st.Matern52Kernel(), 0.5))
        return dict(f1=f1, f2=f2, f3=f1 + f2, f4=1.5 * (f1 + f2), f5=-f2)

    @stt.gppp
    def tbuild():
        f1 = stt.GP(stt.SEKernel())
        f2 = stt.GP(2.0 * stt.with_lengthscale(stt.Matern52Kernel(), 0.5))
        return dict(f1=f1, f2=f2, f3=f1 + f2, f4=1.5 * (f1 + f2), f5=-f2)

    return jbuild(), tbuild()


@pytest.mark.parametrize("p", ["f1", "f2", "f3", "f4", "f5"])
def test_gppp_statistics_match_reference(p):
    jf, tf = _programme_pair()
    rng = np.random.default_rng(0)
    x = rng.normal(size=40)
    x2 = rng.normal(size=30)
    jx, tx = st.GPPPInput(p, jnp.asarray(x)), stt.GPPPInput(p, torch.as_tensor(x))
    for q in ("f1", "f2", "f3", "f4", "f5"):
        jx2, tx2 = st.GPPPInput(q, jnp.asarray(x2)), stt.GPPPInput(q, torch.as_tensor(x2))
        np.testing.assert_allclose(tf.cov2(tx, tx2).numpy(), np.asarray(jf.cov2(jx, jx2)),
                                   rtol=1e-12, atol=1e-14, err_msg=f"cov2 {p} {q}")
        jx3 = st.GPPPInput(q, jnp.asarray(x))
        tx3 = stt.GPPPInput(q, torch.as_tensor(x))
        np.testing.assert_allclose(tf.var2(tx, tx3).numpy(), np.asarray(jf.var2(jx, jx3)),
                                   rtol=1e-12, atol=1e-14, err_msg=f"var2 {p} {q}")
    np.testing.assert_allclose(tf.cov(tx).numpy(), np.asarray(jf.cov(jx)), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tf.var(tx).numpy(), np.asarray(jf.var(jx)), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tf.mean(tx).numpy(), np.asarray(jf.mean(jx)), atol=0)
    # var ≡ diag(cov)
    np.testing.assert_allclose(tf.var(tx).numpy(), np.diagonal(tf.cov(tx).numpy()), rtol=1e-12)


def test_logpdf_posterior_marginals_with_vector_and_full_noise():
    jf, tf = _programme_pair()
    rng = np.random.default_rng(1)
    x = rng.normal(size=50)
    y = rng.normal(size=50)
    xp = rng.normal(size=20)
    noise = 0.05 + rng.uniform(size=50)
    S = np.diag(noise) + 0.01
    for jn, tn in ((jnp.asarray(noise), torch.as_tensor(noise)), (jnp.asarray(S), torch.as_tensor(S))):
        jfx = jf(st.GPPPInput("f3", jnp.asarray(x)), jn)
        tfx = tf(stt.GPPPInput("f3", torch.as_tensor(x)), tn)
        np.testing.assert_allclose(stt.logpdf(tfx, torch.as_tensor(y)).item(),
                                   float(st.logpdf(jfx, jnp.asarray(y))), rtol=1e-11)
        jpost = st.posterior(jfx, jnp.asarray(y))
        tpost = stt.posterior(tfx, torch.as_tensor(y))
        ms = stt.marginals(tpost(stt.GPPPInput("f1", torch.as_tensor(xp)), 0.01))
        ms_ref = st.marginals(jpost(st.GPPPInput("f1", jnp.asarray(xp)), 0.01))
        np.testing.assert_allclose(ms.mean.numpy(), np.asarray(ms_ref.mean), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(ms.var.numpy(), np.asarray(ms_ref.var), rtol=1e-9, atol=1e-12)
        tc = tpost.cov(stt.GPPPInput("f2", torch.as_tensor(xp)))
        jc = jpost.cov(st.GPPPInput("f2", jnp.asarray(xp)))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-9, atol=1e-12)


def test_noise_gradient_is_trace_of_cotangent():
    """DiagNoise adds into the diagonal in place; its gradient is diag(K̄)."""
    with stt.GPC():
        f = stt.GP(stt.SEKernel())
    x = torch.linspace(-1, 1, 7, dtype=torch.float64)
    d = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    W = torch.randn(7, 7, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    K = f(x, d).cov()
    (g,) = torch.autograd.grad((W * K).sum(), d)
    np.testing.assert_allclose(g.item(), W.diagonal().sum().item(), rtol=1e-14)


def test_structural_zero_cross_covariances():
    _, tf = _programme_pair()
    x = torch.linspace(-1, 1, 5, dtype=torch.float64)
    z = stt.cross_cov(tf["f1"], tf["f2"], x, x[:3])
    assert z.shape == (5, 3) and z.dtype == torch.float64 and not z.any()
    assert stt.graph._cross_cov(tf["f2"], tf["f1"], x, x) is None
    assert not stt.cross_var(tf["f1"], tf["f2"], x, x).any()


def test_error_paths():
    """A GP outside a programme, an unknown tag (also inside a BlockData),
    processes of two programmes, GP × GP and an unknown backend all raise;
    a BlockData query, which raised until the cross-process stack was
    ported, now answers."""
    with pytest.raises(RuntimeError):
        stt.GP(stt.SEKernel())
    _, tf = _programme_pair()
    x = torch.zeros(3)
    with pytest.raises(KeyError, match="f1"):
        tf(stt.GPPPInput("nope", x), 0.1)
    with pytest.raises(KeyError, match="f1"):
        tf(stt.BlockData(stt.GPPPInput("f1", x), stt.GPPPInput("nope", x)), 0.1)
    _, tf2 = _programme_pair()
    with pytest.raises(ValueError):
        tf["f1"] + tf2["f1"]
    with pytest.raises(TypeError):
        tf["f1"] * tf["f2"]
    m = tf.mean(stt.BlockData(stt.GPPPInput("f1", x), stt.GPPPInput("f2", x[:2])))
    assert m.shape == (5,) and not m.any()
    with pytest.raises(ValueError):
        stt.config.chol_backend("lax")


def test_config_scopes_nest_and_unwind():
    from stheno_tpu_torch.ops import blocked_cholesky as tbc

    assert tbc._active_bwd_params() == (256, True, "iter", 4096)
    with stt.config.bwd_params(block=512):
        with stt.config.bwd_params(base=128, via_inv=False, mode="fused"):
            assert tbc._active_bwd_params() == (128, False, "fused", 512)
        with pytest.raises(ZeroDivisionError):
            with stt.config.bwd_params(base=64, mode="rec"):
                1 / 0
        assert tbc._active_bwd_params() == (256, True, "iter", 512)
    assert tbc._active_bwd_params() == (256, True, "iter", 4096)
    with pytest.raises(ValueError):
        stt.config.bwd_params(mode="recursive")


def _kernel_pair(name):
    ell = np.asarray([0.6, 1.4])
    jse, tse = st.with_lengthscale(st.SEKernel(), jnp.asarray(ell)), stt.with_lengthscale(
        stt.SEKernel(), torch.as_tensor(ell))
    jm, tm = st.Matern12Kernel(), stt.Matern12Kernel()
    return {
        "sum": (jse + 0.5 * jm, tse + 0.5 * tm),
        "product": (jse * st.Matern52Kernel(), tse * stt.Matern52Kernel()),
        "scaled": (2.5 * (0.4 * jse), 2.5 * (0.4 * tse)),
        "ard_matern32": (st.with_lengthscale(st.Matern32Kernel(), jnp.asarray(ell)),
                         stt.with_lengthscale(stt.Matern32Kernel(), torch.as_tensor(ell))),
    }[name]


@pytest.mark.parametrize("name", ["sum", "product", "scaled", "ard_matern32"])
def test_kernel_algebra_and_diag_match_reference(name):
    jk, tk = _kernel_pair(name)
    rng = np.random.default_rng(5)
    x, y = rng.normal(size=(17, 2)), rng.normal(size=(17, 2))
    tx, ty, jx, jy = torch.as_tensor(x), torch.as_tensor(y), jnp.asarray(x), jnp.asarray(y)
    for got, want in ((stt.kernelmatrix(tk, tx), st.kernelmatrix(jk, jx)),
                      (stt.kernelmatrix(tk, tx, ty), st.kernelmatrix(jk, jx, jy)),
                      (tk(tx, ty), jk(jx, jy)),
                      (stt.kernelmatrix_diag(tk, tx), st.kernelmatrix_diag(jk, jx)),
                      (stt.kernelmatrix_diag(tk, tx, ty), st.kernelmatrix_diag(jk, jx, jy))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


def test_means_and_inputs_match_reference():
    x = np.linspace(-1.0, 2.0, 6)
    for jm, tm in ((st.ZeroMean(), stt.ZeroMean()), (st.ConstMean(jnp.asarray(1.5)), stt.ConstMean(1.5)),
                   (st.FunctionMean(jnp.sin), stt.FunctionMean(torch.sin))):
        np.testing.assert_allclose(tm(torch.as_tensor(x)).numpy(), np.asarray(jm(jnp.asarray(x))),
                                   rtol=1e-15)
    X = np.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(stt.ColVecs(torch.as_tensor(X)).numpy(), np.asarray(st.ColVecs(X)))
    np.testing.assert_array_equal(stt.RowVecs(torch.as_tensor(X)).numpy(), np.asarray(st.RowVecs(X)))
    tb = stt.vcat(stt.GPPPInput("f1", torch.zeros(2)), stt.GPPPInput("f2", torch.zeros(3)))
    jb = st.vcat(st.GPPPInput("f1", jnp.zeros(2)), st.GPPPInput("f2", jnp.zeros(3)))
    assert (len(tb), tb.block_sizes, stt.input_length(tb)) == (len(jb), jb.block_sizes, 5)
    parts = stt.split(tb, torch.arange(5.0))
    assert [p.tolist() for p in parts] == [[0.0, 1.0], [2.0, 3.0, 4.0]]
    with pytest.raises(ValueError):
        stt.split(tb, torch.arange(4.0))


def test_free_verbs_match_reference():
    jf, tf = _programme_pair()
    rng = np.random.default_rng(6)
    x, x2 = rng.normal(size=8), rng.normal(size=5)
    jfx, tfx = jf(st.GPPPInput("f3", jnp.asarray(x)), 0.2), tf(stt.GPPPInput("f3", torch.as_tensor(x)), 0.2)
    jgx = jf(st.GPPPInput("f1", jnp.asarray(x2)))
    tgx = tf(stt.GPPPInput("f1", torch.as_tensor(x2)))
    f1, jf1 = tf["f1"], jf["f1"]
    pairs = [
        (stt.mean(tfx), st.mean(jfx)),
        (stt.cov(tfx), st.cov(jfx)),
        (stt.var(tfx), st.var(jfx)),
        (stt.cov(tfx, tgx), st.cov(jfx, jgx)),
        (stt.cov(f1, torch.as_tensor(x)), st.cov(jf1, jnp.asarray(x))),
        (stt.cov(f1, tf["f3"], torch.as_tensor(x), torch.as_tensor(x2)),
         st.cov(jf1, jf["f3"], jnp.asarray(x), jnp.asarray(x2))),
        (stt.var(f1, torch.as_tensor(x)), st.var(jf1, jnp.asarray(x))),
        (stt.mean_and_cov(tfx)[1], st.mean_and_cov(jfx)[1]),
        (stt.marginals(tfx).std, st.marginals(jfx).std),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


def _block_queries(m, arr):
    rng = np.random.default_rng(11)
    xa, xb, xc = rng.normal(size=6), rng.normal(size=4), rng.normal(size=5)
    B = m.BlockData(m.GPPPInput("f1", arr(xa)), m.GPPPInput("f3", arr(xb)))
    B2 = m.BlockData(m.GPPPInput("f5", arr(xc)), m.GPPPInput("f4", arr(xa)), m.GPPPInput("f2", arr(xb)))
    B3 = m.BlockData(m.GPPPInput("f2", arr(xa)), m.GPPPInput("f4", arr(xb)))  # len(B)
    pairs = [("f2", arr(xa[0])), ("f1", arr(xb[1])), ("f2", arr(xc[2])), ("f5", arr(xa[3]))]
    return B, B2, B3, pairs


def test_blockdata_and_pair_queries_match_reference():
    """BlockData queries and the [(name, x), ...] form (grouped by name in
    order of first appearance) through both packages: statistics, cov2 and
    var2 across two different BlockData, logpdf and posterior marginals."""
    jf, tf = _programme_pair()
    out = []
    for m, f, arr in ((st, jf, jnp.asarray), (stt, tf, torch.as_tensor)):
        B, B2, B3, pairs = _block_queries(m, arr)
        y = arr(np.random.default_rng(12).normal(size=10))
        post = m.posterior(f(B, 0.05), y)
        ms = m.marginals(post(B2, 0.01))
        out.append({
            "mean": f.mean(B), "cov": f.cov(B), "var": f.var(B), "cov2": f.cov2(B, B2),
            "var2": f.var2(B, B3), "cov2_t": f.cov2(B2, B),
            "pairs_cov": f.cov(pairs), "pairs_mean": f.mean(pairs), "pairs_var": f.var(pairs),
            "pairs_cov2": f.cov2(pairs, B), "logpdf": m.logpdf(f(B, 0.05), y),
            "post_mean": ms.mean, "post_var": ms.var, "post_cov2": post.cov2(B2, B),
        })
    for k, want in out[0].items():
        np.testing.assert_allclose(np.asarray(out[1][k]), np.asarray(want), rtol=1e-11, atol=1e-12,
                                   err_msg=k)


def test_pair_query_groups_by_first_appearance():
    _, tf = _programme_pair()
    x = torch.arange(4, dtype=torch.float64)
    pairs = [("f2", x[0]), ("f1", x[1]), ("f2", x[2])]
    B = stt.BlockData(stt.GPPPInput("f2", x[[0, 2]]), stt.GPPPInput("f1", x[1:2]))
    np.testing.assert_array_equal(tf.cov(pairs).numpy(), tf.cov(B).numpy())
    _, v = tf.extract(pairs)
    assert v.block_sizes == (2, 1)


def _sensor_fusion_pair():
    from stheno_tpu.models import workloads as jw
    from stheno_tpu_torch.models import workloads as tw

    return jw.sensor_fusion(), tw.sensor_fusion()


def test_sensor_fusion_joint_posterior_matches_reference():
    """The sensor-fusion model (BASELINE #3): joint conditioning on both
    sensors, read off at the latent and at each sensor, with the example's
    own checks (`examples/sensor_fusion.py`: |E[y1 − f] − noise1_mean| and
    |E[y2 − f] − √0.1·3.5| ≤ 1e-6)."""
    rng = np.random.default_rng(123456)
    x1, x2 = np.sort(rng.uniform(0, 10, 3)), np.sort(rng.uniform(0, 10, 10))
    y = rng.normal(size=13)
    xp = np.linspace(-2.5, 12.5, 200)
    jf, tf = _sensor_fusion_pair()
    res = []
    for m, f, arr in ((st, jf, jnp.asarray), (stt, tf, torch.as_tensor)):
        x = m.BlockData(m.GPPPInput("y1", arr(x1)), m.GPPPInput("y2", arr(x2)))
        post = m.posterior(f(x, 1e-12), arr(y))
        xp_all = m.BlockData(m.GPPPInput("f", arr(xp)), m.GPPPInput("y1", arr(xp)),
                             m.GPPPInput("y2", arr(xp)))
        ms = m.marginals(post(xp_all, 1e-9))
        res.append((np.asarray(ms.mean), np.asarray(ms.var), np.asarray(m.logpdf(f(x, 1e-12), arr(y)))))
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    mf, m1, m2 = np.split(res[1][0], 3)
    err1 = np.max(np.abs((m1 - mf) - (np.sin(xp) - 5.0 + np.sqrt(np.abs(xp)))))
    err2 = np.max(np.abs((m2 - mf) - np.sqrt(1e-1) * 3.5))
    assert err1 < 1e-6 and err2 < 1e-6, (err1, err2)


def _mauna_loa_jax_spec():
    from stheno_tpu import params as JP

    pos = JP.positive
    return dict(
        trend_scale=pos(0.1),
        co2=dict(s_latent=pos(0.3), s_wiggle=pos(0.3), l_wiggle=pos(5.0), s_period=pos(0.3),
                 freq=JP.fixed(1.0), s_noise=pos(0.1), s_mean=pos(1.0)),
        temp=dict(s_trend=pos(1.0), s_wiggle=pos(1.0), l_wiggle=pos(0.5), s_noise=pos(0.1),
                  s_mean=pos(1.0)),
    )


def _mauna_loa_jax(data):
    """The reference's nlml of the Mauna Loa model under constrained
    parameters t, and its posterior marginals at BlockData(f_co2, f_T,
    f_trend) of `xp`."""
    from stheno_tpu.models.workloads import mauna_loa_style

    jd = [jnp.asarray(t.numpy()) for t in data]
    x = st.BlockData(st.GPPPInput("f_co2", jd[0]), st.GPPPInput("f_T", jd[2]))
    y = jnp.concatenate([jd[1], jd[3]])

    def fx(t):
        noise = jnp.concatenate([jnp.full((len(jd[0]),), t["co2"]["s_noise"] ** 2),
                                 jnp.full((len(jd[2]),), t["temp"]["s_noise"] ** 2)])
        return mauna_loa_style(t)(x, noise)

    def nlml(t):
        return -st.logpdf(fx(t), y)

    def predict(t, xp):
        post = st.posterior(fx(t), y)
        q = st.BlockData(st.GPPPInput("f_co2", xp), st.GPPPInput("f_T", xp), st.GPPPInput("f_trend", xp))
        return st.marginals(post(q, 1e-9))

    return nlml, predict


def test_mauna_loa_blocked_matches_reference():
    """The extended Mauna Loa model (BASELINE #4) at a ragged N = 1100 on the
    blocked path on both sides (identity-padded to 2048, backward panels of
    512): −logpdf and its gradient in θ (≤ 1e-8 relative), and the joint
    posterior marginals at BlockData(f_co2, f_T, f_trend)."""
    from stheno_tpu import params as JP
    from stheno_tpu_torch import params as P
    from stheno_tpu_torch.convert import spec_from_numpy

    data = entry.mauna_loa_data(620, 480, torch.float64, device="cpu")
    jnlml, jpredict = _mauna_loa_jax(data)
    jth, junf = JP.init(_mauna_loa_jax_spec())
    xp = np.linspace(-22.0, 25.0, 40)
    s1, s2, s3, s4 = _blocked_scopes(512)
    with s1, s2:
        jval, jgrad = jax.jit(jax.value_and_grad(lambda th: jnlml(junf(th))))(jth)
        # a point away from θ₀, so the posterior is not the prior's
        jms = jax.jit(lambda th, q: jpredict(junf(th), q))(jth + 0.1, jnp.asarray(xp))
    theta0, unflatten = P.init(spec_from_numpy(_mauna_loa_jax_spec(), device="cpu"))
    np.testing.assert_array_equal(theta0.numpy(), np.asarray(jth))
    with s3, s4:
        val, grad = entry.mauna_loa_step(theta0, data)
        ms = entry.mauna_loa_predict(unflatten(theta0 + 0.1), data, torch.as_tensor(xp), noise=1e-9)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-8)
    jg = np.asarray(jgrad)
    np.testing.assert_allclose(grad.numpy(), jg, rtol=0, atol=1e-8 * np.abs(jg).max())
    np.testing.assert_allclose(ms.mean.numpy(), np.asarray(jms.mean), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(ms.var.numpy(), np.asarray(jms.var), rtol=1e-7, atol=1e-9)


def test_host_observations_take_the_covariance_dtype_and_device():
    """A numpy y and a numpy (N, N) noise meet an f32 covariance: the
    results are f32 and agree with f64.  (With the covariance on the card,
    the parent failed on these: tests/test_torch_cuda.py.)"""
    _, tf = _programme_pair()
    rng = np.random.default_rng(13)
    x = torch.as_tensor(rng.normal(size=20), dtype=torch.float32)
    y = rng.normal(size=20)
    S = np.diag(0.1 + rng.uniform(size=20)) + 0.01
    fx = tf(stt.GPPPInput("f3", x), S)
    lp = stt.logpdf(fx, y)
    assert lp.dtype == torch.float32
    post = stt.posterior(fx, y)
    m = post.mean(stt.GPPPInput("f1", x))
    assert m.dtype == torch.float32
    lp64 = stt.logpdf(tf(stt.GPPPInput("f3", x.double()), torch.as_tensor(S)), torch.as_tensor(y))
    np.testing.assert_allclose(lp.item(), lp64.item(), rtol=1e-5)

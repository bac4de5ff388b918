"""The port's pseudo-point path against the JAX package: the collapsed
Titsias `elbo` with its gradient, `posterior_vfe`, `SparseFiniteGP`'s
routing of `logpdf`, `posterior` and `rand`, and the interdomain form of
the pseudo-point programme (inducing points in both latents of f3 = f1 + f2,
`BlockData(f1 at z, f2 at z)`), on the `torch.linalg` route and on the
blocked route (both packages scoped to it, with a backward panel of 256, so
the f32 cases run the kernels' plain versions).  Then the bound's
substitution and products under one reverse rule (`ops/chol.py:_VfeProducts`)
against the composite chain that a `torch.func` transform takes, and the
counts that say which route ran.

The inputs are made with numpy from a seed (`entry.pseudo_points_data`) and
fed to both packages.  Tolerances: f64 value and gradient to rtol 1e-10 (the
gradient against its largest component); f32 to rtol 1e-4, a few hundred
float32 roundings of sums of about a thousand terms."""

from contextlib import ExitStack, contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu
import stheno_tpu as st
import stheno_tpu_torch as stt
from stheno_tpu import params as JP
from stheno_tpu.finite_gp import _sparse_logpdf as j_sparse_logpdf
from stheno_tpu.models.workloads import pseudo_points_model as j_model
from stheno_tpu_torch import entry
from stheno_tpu_torch import params as P
from stheno_tpu_torch.finite_gp import rand_sparse
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-10), "f32": (jnp.float32, torch.float32, 1e-4)}


@contextmanager
def _route(package, route):
    """`package` (the JAX one or the port) on `route`: its library factor
    ("torch"), or the blocked path with backward panels of 256."""
    cfg = package.config
    with ExitStack() as stack:
        if route == "torch":
            stack.enter_context(cfg.chol_backend("lax" if package is stheno_tpu else "torch"))
        else:
            stack.enter_context(cfg.chol_backend("blocked"))
            stack.enter_context(cfg.bwd_params(block=256))
        yield


def _jax_spec(z):
    pos = JP.positive
    return dict(v1=pos(0.8), l1=pos(1.0), v2=pos(0.8), l2=pos(1.0), noise=pos(0.2), z=jnp.asarray(z))


def _jax_objective(x, y):
    """The example's −ELBO (`examples/gppp_and_pseudo_points.py:70-76`)."""

    def neg_elbo(t):
        f = j_model(t)
        fx = f(st.GPPPInput("f3", x), t["noise"])
        u = f(st.BlockData(st.GPPPInput("f1", t["z"]), st.GPPPInput("f2", t["z"])), 1e-6)
        return -st.elbo(st.VFE(u), fx, y)

    return neg_elbo


def _data(n, m, dtype, half_width=None, seed=3):
    """The entry's data; by default z is spaced 1.5 apart, so Kuu (unit
    lengthscales) is well conditioned in f32 too."""
    half_width = 0.75 * m if half_width is None else half_width
    return entry.pseudo_points_data(n, m, dtype, "cpu", seed=seed, half_width=half_width)


def _assert_grad_close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def test_entry_neg_elbo_matches_the_example_objective():
    """`entry.pseudo_points_step` at the example's size (N = 600, 24
    inducing inputs per latent on [−8, 8]) against the JAX example's −ELBO
    and its gradient, at θ₀ and at a point away from it, f64, rtol 1e-10."""
    data = _data(600, 24, torch.float64, half_width=8.0, seed=7)
    x, y, z = (a.numpy() for a in data)
    jth, junf = JP.init(_jax_spec(z))
    theta0, _ = P.init(entry.pseudo_points_spec(data[2]))
    np.testing.assert_array_equal(theta0.numpy(), np.asarray(jth))
    vg = jax.jit(jax.value_and_grad(lambda th: _jax_objective(jnp.asarray(x), jnp.asarray(y))(junf(th))))
    for shift in (0.0, 0.15):
        jval, jgrad = vg(jth + shift)
        val, grad = entry.pseudo_points_step(theta0 + shift, data)
        np.testing.assert_allclose(val.item(), float(jval), rtol=1e-10)
        _assert_grad_close(grad.numpy(), jgrad, 1e-10)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("route", ["torch", "blocked"])
def test_elbo_and_gradient_match_reference(route, dtype):
    """The interdomain −ELBO and its gradient in θ = (l1, l2, noise, v1,
    v2, z).  On the blocked route M = 2·256 inducing points give a
    two-panel Kuu and B (kernels 2 and 3's plain versions in f32)."""
    jdt, tdt, rtol = DTYPES[dtype]
    m = 256 if route == "blocked" else 20
    data = _data(600, m, tdt)
    x, y, z = (jnp.asarray(a.numpy()) for a in data)
    jth, junf = JP.init(_jax_spec(z))
    jth = jth.astype(jdt)
    theta0, _ = P.init(entry.pseudo_points_spec(data[2]))
    with _route(stheno_tpu, route):
        jval, jgrad = jax.jit(jax.value_and_grad(lambda th: _jax_objective(x, y)(junf(th))))(jth)
    with _route(stt, route):
        val, grad = entry.pseudo_points_step(theta0, data)
    assert val.dtype == tdt
    np.testing.assert_allclose(val.item(), float(jval), rtol=rtol)
    _assert_grad_close(grad.numpy(), jgrad, rtol if dtype == "f64" else 5e-3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("route", ["torch", "blocked"])
def test_posterior_vfe_matches_reference(route, dtype):
    """Marginals of the approximate posterior at BlockData(f1, f3): observe
    f3, read off the latent f1, with the inducing points in both latents."""
    jdt, tdt, rtol = DTYPES[dtype]
    m = 256 if route == "blocked" else 20
    data = _data(600, m, tdt)
    x, y, z = (jnp.asarray(a.numpy()) for a in data)
    xp = np.linspace(-0.7 * m, 0.7 * m, 37)
    jt = {k: jnp.asarray(v, dtype=jdt) for k, v in dict(v1=1.1, l1=1.3, v2=0.5, l2=0.6, noise=0.1).items()}
    tt = {k: torch.tensor(float(v), dtype=tdt) for k, v in jt.items()}
    jt["z"], tt["z"] = z, data[2]
    with _route(stheno_tpu, route):
        f = j_model(jt)
        fx = f(st.GPPPInput("f3", x), jt["noise"])
        u = f(st.BlockData(st.GPPPInput("f1", z), st.GPPPInput("f2", z)), 1e-6)
        q = st.BlockData(st.GPPPInput("f1", jnp.asarray(xp, dtype=jdt)),
                         st.GPPPInput("f3", jnp.asarray(xp, dtype=jdt)))
        jms = jax.jit(lambda: st.marginals(st.posterior_vfe(st.VFE(u), fx, y)(q, 1e-9)))()
    with _route(stt, route):
        ms = entry.pseudo_points_predict(tt, data, torch.as_tensor(xp, dtype=tdt), noise=1e-9)
    atol = 1e-10 if dtype == "f64" else 1e-4
    np.testing.assert_allclose(ms.mean.numpy(), np.asarray(jms.mean), rtol=rtol, atol=atol)
    np.testing.assert_allclose(ms.var.numpy(), np.asarray(jms.var), rtol=rtol, atol=atol)


def _simple_pair():
    """One GP on each side, SE over Matern32, with its inputs and data."""
    rng = np.random.default_rng(11)
    x = np.sort(rng.uniform(0, 4, 40))
    z = np.linspace(0, 4, 9)
    y = np.sin(2 * x) + 0.2 * rng.normal(size=40)
    with st.GPC():
        jf = st.GP(1.3 * st.with_lengthscale(st.Matern32Kernel(), 0.7))
    with stt.GPC():
        tf = stt.GP(1.3 * stt.with_lengthscale(stt.Matern32Kernel(), 0.7))
    return jf, tf, x, z, y


def test_sparse_finite_gp_routing_matches_reference():
    """`logpdf` of a SparseFiniteGP is the ELBO (per column of a 2-D y, a
    loop where the reference vmaps), its `posterior` and the
    `posterior(VFE(u), fx, y)` form are the VFE posterior, `elbo_fx` is
    `elbo`, and its `cov` raises."""
    jf, tf, x, z, y = _simple_pair()
    Y = np.stack([y, np.cos(x), -y], axis=1)
    xq = np.linspace(0.2, 3.8, 11)
    jfx, jfz = jf(jnp.asarray(x), 0.1), jf(jnp.asarray(z), 1e-9)
    tx, tz, txq = (torch.as_tensor(a) for a in (x, z, xq))
    tfx, tfz = tf(tx, 0.1), tf(tz, 1e-9)
    jsp, tsp = st.SparseFiniteGP(jfx, jfz), stt.SparseFiniteGP(tfx, tfz)

    @jax.jit
    def reference(yy, YY, q):
        post = st.posterior(jsp, yy)
        return (st.logpdf(jsp, yy), j_sparse_logpdf(jsp, YY), post.mean(q), post.cov(q),
                post.cov2(q, q[:4]))

    jlp, jcols, jm, jcov, jcov2 = reference(jnp.asarray(y), jnp.asarray(Y), jnp.asarray(xq))
    np.testing.assert_allclose(stt.logpdf(tsp, y).item(), float(jlp), rtol=1e-10)
    np.testing.assert_allclose(stt.logpdf(tsp, y).item(), stt.elbo(stt.VFE(tfz), tfx, y).item(),
                               rtol=1e-14)
    np.testing.assert_allclose(stt.elbo_fx(tfx, y, tfz).item(), stt.logpdf(tsp, y).item(), rtol=1e-14)
    cols = stt.logpdf(tsp, Y)
    assert cols.shape == (3,)
    np.testing.assert_allclose(cols.numpy(), np.asarray(jcols), rtol=1e-10)
    for post in (stt.posterior(tsp, y), stt.posterior(stt.VFE(tfz), tfx, y),
                 stt.posterior_vfe(stt.VFE(tfz), tfx, y)):
        assert isinstance(post, stt.ApproxPosteriorGP)
        np.testing.assert_allclose(post.mean(txq).numpy(), np.asarray(jm), rtol=1e-10, atol=1e-12)
    tpost = stt.posterior(tsp, y)
    np.testing.assert_allclose(tpost.cov(txq).numpy(), np.asarray(jcov), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tpost.cov2(txq, txq[:4]).numpy(), np.asarray(jcov2),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tpost.var2(txq, txq).numpy(), tpost.var(txq).numpy(), rtol=1e-12)
    assert len(tsp) == 40
    m, v = tsp.mean_and_var()
    np.testing.assert_allclose(v.numpy(), tfx.var().numpy())
    with pytest.raises(RuntimeError, match="sparse GP"):
        tsp.cov()


def test_elbo_bounds_and_errors():
    """The ELBO lies below the exact logpdf and reaches it with z = x; it
    needs diagonal noise (TypeError otherwise) and pseudo-points of the
    same programme (TypeError otherwise)."""
    _, tf, x, z, y = _simple_pair()
    tx, tz = torch.as_tensor(x), torch.as_tensor(z)
    fx = tf(tx, 0.1)
    lp = stt.logpdf(fx, y).item()
    assert stt.elbo(stt.VFE(tf(tz, 1e-9)), fx, y).item() < lp
    np.testing.assert_allclose(stt.elbo(stt.VFE(tf(tx, 1e-9)), fx, y).item(), lp, rtol=1e-6)
    with pytest.raises(TypeError, match="diagonal"):
        stt.elbo(stt.VFE(tf(tz, 1e-9)), tf(tx, 0.1 * torch.eye(40, dtype=torch.float64)), y)
    with stt.GPC():
        other = stt.GP(stt.SEKernel())
    prog = entry.build_pseudo_points(dict(v1=1.0, l1=1.0, v2=1.0, l2=1.0))
    with pytest.raises(TypeError, match="same programme"):
        stt.elbo(stt.VFE(other(tz, 1e-9)), prog(stt.GPPPInput("f3", tx), 0.1), y)


def test_interdomain_bound_tightens_and_posterior_crosses_processes():
    """The reference's interdomain test on the port: inducing points in f1
    alone bound the logpdf loosely; dense ones in f1 and f2 come within
    0.2 of it, and the posterior answers at f1 and f3."""
    rng = np.random.default_rng(5)
    t = dict(v1=1.0, l1=1.0, v2=1.0, l2=1.0)
    f = entry.build_pseudo_points(t)
    x = torch.as_tensor(rng.uniform(-3, 3, 30))
    fx = f(stt.GPPPInput("f3", x), 0.2)
    y = stt.rand(torch.Generator().manual_seed(0), fx)
    lp = stt.logpdf(fx, y).item()
    el = stt.elbo(stt.VFE(f(stt.GPPPInput("f1", torch.linspace(-3, 3, 10, dtype=torch.float64)), 1e-9)),
                  fx, y).item()
    zd = torch.linspace(-3.2, 3.2, 40, dtype=torch.float64)
    u = f(stt.BlockData(stt.GPPPInput("f1", zd), stt.GPPPInput("f2", zd)), 1e-9)
    el_both = stt.elbo(stt.VFE(u), fx, y).item()
    assert el < el_both < lp and lp - el_both < 0.2
    ap = stt.posterior_vfe(stt.VFE(u), fx, y)
    xp = torch.linspace(-3, 3, 8, dtype=torch.float64)
    assert bool(torch.isfinite(ap.mean(stt.GPPPInput("f1", xp))).all())
    assert bool(torch.isfinite(ap.mean(stt.GPPPInput("f3", xp))).all())


def test_rand_sparse_is_the_observation_law():
    """`rand_sparse` (and `rand` of a SparseFiniteGP) sample the
    observation FiniteGP: 400 columns whitened by its factor have mean 0
    and variance 1 within 5σ."""
    _, tf, x, z, _ = _simple_pair()
    tx, tz = torch.as_tensor(x), torch.as_tensor(z)
    sp = stt.SparseFiniteGP(tf(tx, 0.1), tf(tz, 1e-9))
    gen = torch.Generator().manual_seed(4)
    ys = rand_sparse(gen, sp, 400)
    assert ys.shape == (40, 400) and stt.rand(gen, sp).shape == (40,)
    L = torch.linalg.cholesky(sp.fobs.cov())
    w = torch.linalg.solve_triangular(L, ys - sp.mean()[:, None], upper=False)
    n = w.numel()
    assert abs(w.mean().item()) < 5 / np.sqrt(n)
    assert abs(w.var(unbiased=False).item() - 1) < 5 * np.sqrt(2 / n)


def test_fit_improves_the_bound_at_the_example_size():
    """Eight Adam steps of `entry.pseudo_points_fit` on the example's size
    lower the −ELBO and keep z free."""
    data = _data(600, 24, torch.float64, half_width=8.0, seed=7)
    res = entry.pseudo_points_fit(8, 2e-2, data=data)
    assert res.losses[-1] < res.losses[0]
    assert not torch.equal(res.params["z"], data[2])


# ---------------------------------------------------------------------------
# The substitution and its products under one reverse rule
# (`ops/chol.py:_VfeProducts`) against the composite chain
# ---------------------------------------------------------------------------


def _products_inputs(m, n, seed=0, dtype=torch.float64):
    """(L, K̃, b) as the bound makes them: L = chol(Kuu) of m inducing inputs
    1.5 apart (SE, unit lengthscale), K̃ = Kuf / √s and b = (y − mean) / √s
    under a heteroscedastic noise diagonal s and a non-zero mean."""
    g = torch.Generator().manual_seed(seed)
    half = 0.75 * m
    z = torch.linspace(-half, half, m, dtype=dtype)
    x, _ = torch.sort(torch.rand(n, generator=g, dtype=dtype) * (2 * half) - half)

    def se(a, c):
        return torch.exp(-0.5 * (a[:, None] - c[None, :]) ** 2)

    L = torch.linalg.cholesky(se(z, z) + 1e-6 * torch.eye(m, dtype=dtype))
    s = 0.05 + 0.3 * torch.rand(n, generator=g, dtype=dtype)
    y = torch.sin(x / 2) + s.sqrt() * torch.randn(n, generator=g, dtype=dtype)
    mean = 0.7 + 0.1 * x
    return L, se(z, x) / s.sqrt()[None, :], (y - mean) / s.sqrt()


def _probe(m, seed=1, dtype=torch.float64):
    """A scalar of (A Aᵀ, A b, Σ A²) whose cotangents are dense: a
    non-symmetric one of A Aᵀ, so S' = B̄' + B̄'ᵀ + 2 t̄ I is tested whole."""
    g = torch.Generator().manual_seed(seed)
    W = torch.randn(m, m, generator=g, dtype=dtype)
    v = torch.randn(m, generator=g, dtype=dtype)
    return lambda Bp, a, t: torch.sum(W * Bp) + a @ v - 0.3 * t


def _values_and_grads(products, inputs, probe):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    outs = products(*leaves)
    return [o.detach() for o in outs], torch.autograd.grad(probe(*outs), leaves)


def _sym_leaf(monkeypatch, leaf):
    """`_SYM_LEAF` set to `leaf` (None keeps it), so that B' = A Aᵀ is built
    from its lower blocks at test sizes."""
    from stheno_tpu_torch.ops import chol as C

    if leaf is not None:
        monkeypatch.setattr(C, "_SYM_LEAF", leaf)


@pytest.mark.parametrize("m,levels", [(512, 2), (384, 1), (1100, 2), (200, 0)])
def test_the_symmetric_product_is_the_full_product_mirrored(m, levels, monkeypatch):
    """`_sym_product(A)` at `_SYM_LEAF` = 128: one batched product a level
    and one for the leaves (none where M < 256: `A @ A.T`), equal to
    `A @ A.T` to rtol 1e-12 in f64 and exactly symmetric; M = 1100 splits
    twice into leaves of 275 rows."""
    from stheno_tpu_torch.ops import chol as C

    _sym_leaf(monkeypatch, 128)
    products = []
    bmm = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda *a, **k: products.append(a[0].shape) or bmm(*a, **k))
    L, Kt, _ = _products_inputs(m, 300)
    A = torch.linalg.solve_triangular(L, Kt, upper=False)
    got, want = C._sym_product(A), A @ A.T
    h = m >> levels
    assert products == ([(2 ** (lvl - 1), m >> lvl, 300) for lvl in range(1, levels + 1)]
                        + [(2**levels, h, 300)] if levels else [])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12 * want.abs().max().item())
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("route,m,leaf", [
    pytest.param("torch", 20, None, id="torch-20"),
    pytest.param("blocked", 512, None, id="blocked-512"),
    pytest.param("blocked", 1100, None, id="blocked-1100"),
    pytest.param("torch", 384, 128, id="torch-384-sym"),
    pytest.param("blocked", 512, 128, id="blocked-512-sym"),
    pytest.param("blocked", 1100, 128, id="blocked-1100-sym"),
])
def test_fused_products_match_the_composite_chain(route, m, leaf, monkeypatch):
    """Value and gradient of L, K̃ and b through `_VfeProducts` against
    `solve_lower` and autograd's products, f64, rtol 1e-10, on the
    `torch.linalg` route and the blocked one (N = 600; M = 1100 is
    identity-padded to two panels of 1024), with B' as one product and, at
    `_SYM_LEAF` = 128 (`-sym`), from its lower blocks."""
    from stheno_tpu_torch.ops import chol as C

    _sym_leaf(monkeypatch, leaf)
    inputs, probe = _products_inputs(m, 600), _probe(m)
    with ExitStack() as stack:
        if route == "blocked":
            stack.enter_context(stt.config.chol_backend("blocked"))
        assert C._use_blocked(inputs[0]) == (route == "blocked")
        got = _values_and_grads(C._VfeProducts.apply, inputs, probe)
        want = _values_and_grads(C._vfe_products_composite, inputs, probe)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-10 * w.abs().max().item())
    for g, w in zip(got[1], want[1]):
        _assert_grad_close(g.numpy(), w.numpy(), 1e-10)


@pytest.mark.parametrize("route,m,leaf", [
    pytest.param("torch", 5, None, id="torch"),
    pytest.param("blocked", 5, None, id="blocked"),
    pytest.param("torch", 8, 2, id="torch-sym"),
    pytest.param("blocked", 8, 2, id="blocked-sym"),
])
def test_fused_products_pass_gradcheck(route, m, leaf, monkeypatch):
    """gradcheck of `_VfeProducts`; at M = 8 with `_SYM_LEAF` = 2 (`-sym`),
    B' from its lower blocks over two levels."""
    from stheno_tpu_torch.ops import chol as C

    _sym_leaf(monkeypatch, leaf)
    inputs = [t.requires_grad_(True) for t in _products_inputs(m, 9, seed=2)]
    with ExitStack() as stack:
        if route == "blocked":
            stack.enter_context(stt.config.chol_backend("blocked"))
        assert torch.autograd.gradcheck(C._VfeProducts.apply, inputs)


def test_the_fused_rule_refuses_to_be_differentiated_twice():
    """A is saved detached from K̃, so a gradient taken with
    `create_graph=True` raises rather than dropping part of the second
    derivative."""
    from stheno_tpu_torch.ops import chol as C

    inputs = [t.requires_grad_(True) for t in _products_inputs(5, 9, seed=2)]
    with pytest.raises(RuntimeError, match="torch.func"):
        torch.autograd.grad(_probe(5)(*C.vfe_products(*inputs)), inputs, create_graph=True)


def test_second_derivatives_run_under_the_transform():
    """Hessian-vector products of L, K̃ and b through `vfe_products` under
    `torch.func` equal plain autograd's double backward of the composite
    chain (f64, rtol 1e-10)."""
    from stheno_tpu_torch.ops import chol as C

    inputs, probe = _products_inputs(5, 9, seed=2), _probe(5)
    g = torch.Generator().manual_seed(3)
    vs = [torch.randn(t.shape, generator=g, dtype=t.dtype) for t in inputs]

    def hvp_of(products):
        def f(*args):
            return probe(*products(*args))

        return f

    def directional(*args):
        grads = torch.func.grad(hvp_of(C.vfe_products), argnums=(0, 1, 2))(*args)
        return sum(torch.sum(gr * v) for gr, v in zip(grads, vs))

    got = torch.func.grad(directional, argnums=(0, 1, 2))(*inputs)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    grads = torch.autograd.grad(hvp_of(C._vfe_products_composite)(*leaves), leaves, create_graph=True)
    want = torch.autograd.grad(sum(torch.sum(gr * v) for gr, v in zip(grads, vs)), leaves)
    for a, w in zip(got, want):
        _assert_grad_close(a.detach().numpy(), w.numpy(), 1e-10)


def _neg_elbo_problem():
    data = _data(600, 10, torch.float64)
    theta, unflatten = P.init(entry.pseudo_points_spec(data[2]))
    return theta, lambda th: entry.pseudo_points_neg_elbo(unflatten(th), data)


def test_the_transform_fallback_gives_the_fused_gradient():
    """Under `torch.func.grad` the bound takes the composite chain; its
    gradient is the fused route's (f64, rtol 1e-10)."""
    theta, objective = _neg_elbo_problem()
    th = theta.clone().requires_grad_(True)
    (fused,) = torch.autograd.grad(objective(th), th)
    composite = torch.func.grad(objective)(theta)
    _assert_grad_close(composite.numpy(), fused.numpy(), 1e-10)


def test_each_route_is_counted_on_its_span():
    """`vfe.fused` once on the one `solve.reverse` under each `elbo` whose
    backward ran; `vfe.composite` once on the `elbo` under the transform,
    with no reverse rule of the fused route there; a forward alone counts
    neither."""
    from stheno_tpu_torch.utils import logging as T

    theta, objective = _neg_elbo_problem()
    T.clear()
    try:
        with T.recording():
            for _ in range(2):
                th = theta.clone().requires_grad_(True)
                objective(th).backward()
            torch.func.grad(objective)(theta)
            with torch.no_grad():
                objective(theta)
        recs = T.spans()
    finally:
        T.clear()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["elbo"] * 4
    for i, root in enumerate(roots):
        call = [r for r in recs if r["trace"] == root["id"]]
        reverse = [r for r in call if r["name"] == "solve.reverse"]
        assert not any("vfe.composite" in r["counts"] for r in call if r is not root)
        assert not any("vfe.fused" in r["counts"] for r in call if r not in reverse)
        if i < 2:
            assert [(r["parent"], r["counts"].get("vfe.fused")) for r in reverse] == [(root["id"], 1)]
            assert "vfe.composite" not in root["counts"]
        else:
            assert reverse == []
            assert root["counts"].get("vfe.composite") == (1 if i == 2 else None)


@pytest.mark.parametrize("leaf,engaged", [(5, True), (11, False)])
def test_the_lower_block_route_is_counted_on_the_forward_span(leaf, engaged, monkeypatch):
    """`vfe.sym` once on the span the forward ran in (each `elbo`, M = 20)
    where B' is built from its lower blocks (`_SYM_LEAF` = 5: two levels,
    leaves of 5 rows), with or without a backward; absent where M is below
    2 · `_SYM_LEAF` (11) and under the `torch.func` transform, which takes
    the composite chain; on no other span."""
    from stheno_tpu_torch.utils import logging as T

    _sym_leaf(monkeypatch, leaf)
    theta, objective = _neg_elbo_problem()
    T.clear()
    try:
        with T.recording():
            th = theta.clone().requires_grad_(True)
            objective(th).backward()
            torch.func.grad(objective)(theta)
            with torch.no_grad():
                objective(theta)
        recs = T.spans()
    finally:
        T.clear()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["elbo"] * 3
    assert not any("vfe.sym" in r["counts"] for r in recs if r not in roots)
    want = 1 if engaged else None
    assert [r["counts"].get("vfe.sym") for r in roots] == [want, None, want]

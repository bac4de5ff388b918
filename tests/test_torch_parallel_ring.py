"""The port's matrix-free ring (`stheno_tpu_torch.parallel.ring`) in gloo
groups of P = 2 and 4 on the CPU, against `stheno_tpu.parallel.ring` on a
P-device slice of the 8 virtual CPU devices and dense oracles: the ring
matvec (one and several right-hand sides, D = 1 and 2) and its
hyperparameter gradient through the ring, CG solves and posterior
marginals, and the stochastic logpdf: its value against the dense one,
its exact y-gradient, and its Hutchinson hyperparameter gradient against
the dense gradient.  `pcg_solve` and `slq_logdet` run in this process
against dense oracles and the reference's CG."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as st
from stheno_tpu.graph import GPC
from stheno_tpu.parallel import rows_mesh, shard_rows
from stheno_tpu.parallel.ring import pcg_solve, ring_gp_solve, ring_matvec
from stheno_tpu_torch.kernels import SEKernel as TSE
from stheno_tpu_torch.kernels import with_lengthscale as t_with_lengthscale
from stheno_tpu_torch.parallel import pcg_solve as t_pcg_solve
from stheno_tpu_torch.parallel.ring import lanczos_tridiag, slq_logdet
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_dist_ranks import spawn

N, N_HGRAD = 64, 96


def _kernel(v=1.7, ell=0.9):
    return v * st.with_lengthscale(st.SEKernel(), ell)


def _dense_K(x, noise, v=1.7, ell=0.9):
    return np.asarray(_kernel(v, ell).matrix(jnp.asarray(x), jnp.asarray(x))) + noise * np.eye(len(x))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(42)
    return dict(
        x=np.sort(rng.uniform(-3, 3, N)), v=rng.normal(size=N), y=rng.normal(size=N),
        x2d=rng.normal(size=(N, 2)), V=rng.normal(size=(N, 5)), xs=np.linspace(-2.5, 2.5, 33),
        x96=np.sort(rng.uniform(-3, 3, N_HGRAD)), y96=rng.normal(size=N_HGRAD),
    )


def _reference(p, inp):
    mesh = rows_mesh(p)
    x, v, y = (shard_rows(mesh, jnp.asarray(inp[k])) for k in ("x", "v", "y"))

    @jax.jit
    def pipeline(x, v, y, x2d, V):
        qform = lambda ell: jnp.vdot(v, ring_matvec(mesh, _kernel(ell=ell), x, v, noise=0.2))  # noqa: E731
        q, dq = jax.value_and_grad(qform)(0.9)
        sol, _ = ring_gp_solve(mesh, _kernel(), x, y, 0.2, tol=1e-12)
        return dict(mv=ring_matvec(mesh, _kernel(), x, v, noise=0.3),
                    mv2=ring_matvec(mesh, _kernel(), x2d, V, noise=0.1), qform=q, dqform=dq,
                    solve=sol)

    with mesh:
        out = pipeline(x, v, y, shard_rows(mesh, jnp.asarray(inp["x2d"])),
                       shard_rows(mesh, jnp.asarray(inp["V"])))
    out = {k: np.asarray(val) for k, val in out.items()}
    post = st.posterior(st.GP(_kernel(), gpc=GPC())(jnp.asarray(inp["x"]), 0.1), jnp.asarray(inp["y"]))
    xs = jnp.asarray(inp["xs"])
    out["dense_m"], out["dense_v"] = np.asarray(post.mean(xs)), np.asarray(post.var(xs))
    xd, yd = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])
    out["dense_lp"] = float(st.logpdf(st.GP(_kernel(), gpc=GPC())(xd, 0.2), yd))

    def dense(params):
        k = params["v"] * st.with_lengthscale(st.SEKernel(), params["l"])
        return st.logpdf(st.GP(k, gpc=GPC())(jnp.asarray(inp["x96"]), params["noise"]),
                         jnp.asarray(inp["y96"]))

    g = jax.grad(dense)(dict(v=jnp.asarray(1.7), l=jnp.asarray(0.9), noise=jnp.asarray(0.2)))
    out["dense_hgrad"] = np.asarray([g["v"], g["l"], g["noise"]])
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def run(request, inputs, tmp_path_factory):
    p = request.param
    port = spawn("ring", p, inputs, tmp_path_factory.mktemp("ring"))
    return p, port, _reference(p, inputs)


def _rows(port, key):
    return np.concatenate([o[key] for o in port])


def test_ring_matvec_matches_the_reference_and_dense(run, inputs):
    _, port, ref = run
    mv = _rows(port, "mv")
    np.testing.assert_allclose(mv, ref["mv"], rtol=1e-10)
    np.testing.assert_allclose(mv, _dense_K(inputs["x"], 0.3) @ inputs["v"], rtol=1e-10)


def test_ring_matvec_several_right_hand_sides_and_2d_inputs(run, inputs):
    _, port, ref = run
    mv2 = _rows(port, "mv2")
    assert mv2.shape == (N, 5)
    np.testing.assert_allclose(mv2, ref["mv2"], rtol=1e-9)
    np.testing.assert_allclose(mv2, _dense_K(inputs["x2d"], 0.1) @ inputs["V"], rtol=1e-9)


def test_hyperparameter_gradient_through_the_ring(run):
    """d(vᵀ K̂(ℓ) v)/dℓ through the ring's sends, on every rank."""
    _, port, ref = run
    for o in port:
        np.testing.assert_allclose(o["qform"], ref["qform"], rtol=1e-10)
        np.testing.assert_allclose(o["dqform"], ref["dqform"], rtol=1e-9)


def test_ring_gp_solve_matches_dense(run, inputs):
    _, port, ref = run
    sol = _rows(port, "solve")
    np.testing.assert_allclose(sol, np.linalg.solve(_dense_K(inputs["x"], 0.2), inputs["y"]), atol=1e-8)
    np.testing.assert_allclose(sol, ref["solve"], atol=1e-8)
    assert len({int(o["solve_iters"]) for o in port}) == 1 and 0 < port[0]["solve_iters"] <= N + 1


def test_ring_posterior_mean_var_matches_the_dense_posterior(run):
    _, port, ref = run
    for o in port:
        np.testing.assert_allclose(o["post_m"], ref["dense_m"], atol=1e-7)
        np.testing.assert_allclose(o["post_v"], ref["dense_v"], atol=1e-7)
        assert all(it > 0 for it in o["post_iters"])


def test_ring_gp_logpdf_matches_dense(run):
    """The SLQ estimate (32 probes, 30 Lanczos steps) within the
    reference's statistical bound; the same on every rank."""
    _, port, ref = run
    d = ref["dense_lp"]
    for o in port:
        assert abs(float(o["lp"]) - d) < 0.02 * abs(d) + 1.0
        assert float(o["lp"]) == float(port[0]["lp"])


def test_ring_gp_logpdf_ygrad_is_exact(run, inputs):
    _, port, _ = run
    np.testing.assert_allclose(_rows(port, "ygrad"),
                               -np.linalg.solve(_dense_K(inputs["x"], 0.2), inputs["y"]), atol=1e-6)


def test_ring_gp_logpdf_hyperparameter_gradient_against_dense(run):
    """The Hutchinson/SLQ gradient (48 probes) in (v, ℓ, noise) against the
    dense gradient, within the reference's bound, and equal on every rank."""
    _, port, ref = run
    for o in port:
        for s, d in zip(o["hgrad"], ref["dense_hgrad"]):
            assert abs(s - d) <= 0.15 * abs(d) + 0.6, (s, d)
        np.testing.assert_array_equal(o["hgrad"], port[0]["hgrad"])


def test_pcg_solve_dense_oracle():
    rng = np.random.default_rng(42)
    n = 96
    A = rng.normal(size=(n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.normal(size=(n, 2))
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    x, iters = t_pcg_solve(lambda v: At @ v, bt, tol=1e-12)
    assert 0 < iters < n + 1
    np.testing.assert_allclose(A @ x.numpy(), b, rtol=1e-8)
    xv, _ = t_pcg_solve(lambda v: At @ v, bt[:, 0], tol=1e-12)
    np.testing.assert_allclose(xv.numpy(), x[:, 0].numpy(), rtol=1e-7)
    xj, it_j = pcg_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), tol=1e-12)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9)
    assert iters == int(it_j)


def test_slq_logdet_dense_oracle():
    """SLQ against the dense logdet (f64, full reorthogonalisation), and
    Lanczos's tridiagonal against the reference's on the same probes."""
    from stheno_tpu.parallel.ring import lanczos_tridiag as j_lanczos

    rng = np.random.default_rng(42)
    n = 256
    x = np.sort(rng.uniform(-3, 3, n))
    K = _dense_K(x, 0.3)
    Kt = torch.as_tensor(K)
    est, Z = slq_logdet(lambda V: Kt @ V, torch.Generator().manual_seed(0), n, m=30, num_probes=32)
    ref = 2.0 * np.sum(np.log(np.diag(np.linalg.cholesky(K))))
    assert abs(float(est) - ref) < 0.03 * abs(ref) + 1.0
    assert Z.shape == (n, 32) and bool(torch.all(Z.abs() == 1))
    V0 = Z / np.sqrt(n)
    a, b = lanczos_tridiag(lambda V: Kt @ V, V0, 12)
    ja, jb = j_lanczos(lambda V: jnp.asarray(K) @ V, jnp.asarray(V0.numpy()), 12)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-8)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-8)


def test_ring_kernel_is_the_port_kernel():
    """The ranks build their kernel as the port's own (v·SE(·/ℓ))."""
    k = 1.7 * t_with_lengthscale(TSE(), 0.9)
    x = torch.linspace(-1.0, 1.0, 5, dtype=torch.float64)
    np.testing.assert_allclose(k.matrix(x, x).numpy(), _dense_K(x.numpy(), 0.0), rtol=1e-12)

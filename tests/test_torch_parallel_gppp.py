"""The port's sharded GPPP verbs (`stheno_tpu_torch.parallel.gppp`) in
gloo groups of P = 2 and 4 on the CPU, against `stheno_tpu.parallel.gppp`
on a P-device slice of the 8 virtual CPU devices: `sharded_logpdf` of a
composite programme and its hyperparameter gradient on every rank,
`sharded_posterior` across processes (observe f3, read f1; a `BlockData`
query), `sharded_cov` of a joint query whose blocks straddle the ranks'
rows, `sharded_rand`'s whitened statistics, and no N×N tensor on any rank.
f64: 1e-10 relative for values, 1e-8 for gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import stheno_tpu as st
from stheno_tpu import BlockData, FullNoise, GPPPInput, gppp
from stheno_tpu.parallel import rows_mesh, sharded_logpdf, sharded_posterior
from stheno_tpu.parallel.gppp import sharded_chol, sharded_cov
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_dist_ranks import spawn

N, B, NP = 64, 8, 16
N_LARGE, B_LARGE = 256, 16
NUM_DRAWS = 200
THETA = dict(v=1.3, l=0.7)


@gppp
def _composite(theta):
    f1 = st.GP(theta["v"] * st.with_lengthscale(st.SEKernel(), theta["l"]))
    f2 = st.GP(st.Matern32Kernel())
    return dict(f1=f1, f2=f2, f3=f1 + f2)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(42)
    G = rng.normal(size=(N, N))
    return dict(
        x=np.linspace(-3.0, 3.0, N), y=rng.normal(size=N), xp=np.linspace(-2.5, 2.5, NP),
        theta=THETA, B=B, x1=np.sort(rng.uniform(-3, 3, 24)), x2=np.sort(rng.uniform(-3, 3, 40)),
        noise_vec=rng.uniform(0.05, 0.2, N), noise_full=G @ G.T / N + 0.1 * np.eye(N),
        x_rand=np.linspace(-3.0, 3.0, N), num_draws=NUM_DRAWS,
        x_large=np.linspace(-3.0, 3.0, N_LARGE), B_large=B_LARGE,
    )


def _reference(p, inp):
    mesh = rows_mesh(p)
    x, y, xp = (jnp.asarray(inp[k]) for k in ("x", "y", "xp"))
    theta = {k: jnp.asarray(v) for k, v in inp["theta"].items()}
    xq = GPPPInput("f1", xp)
    xb = BlockData(GPPPInput("f1", jnp.asarray(inp["x1"])), GPPPInput("f3", jnp.asarray(inp["x2"])))

    @jax.jit
    def pipeline(theta):
        lp, g = jax.value_and_grad(
            lambda t: sharded_logpdf(mesh, _composite(t)(GPPPInput("f3", x), 0.1), y, block_size=B)
        )(theta)
        f = _composite(theta)
        post = sharded_posterior(mesh, f(GPPPInput("f3", x), 0.1), y, block_size=B)
        m, v = post.mean_and_var(xq)
        return dict(lp=lp, grad=jnp.stack([g[k] for k in THETA]), post_m=m, post_v=v,
                    post_C=post.cov(xq),
                    post_mb=post.mean(BlockData(GPPPInput("f1", xp), GPPPInput("f2", xp))),
                    post_C2=post.cov2(xq, xq),
                    post_v2=post.var2(GPPPInput("f2", xp[::2]), GPPPInput("f2", xp[::2])),
                    chol=sharded_chol(mesh, f(GPPPInput("f3", x), 0.1), block_size=B),
                    cov_block=sharded_cov(mesh, f(xb, jnp.asarray(inp["noise_vec"]))),
                    cov_full=sharded_cov(mesh, f(xb, FullNoise(jnp.asarray(inp["noise_full"])))))

    with mesh:
        out = pipeline(theta)
    fr = _composite(theta)(GPPPInput("f3", jnp.asarray(inp["x_rand"])), 0.1)
    m_r, K_r = fr.mean_and_cov()
    post_dense = st.posterior(_composite(theta)(GPPPInput("f3", x), 0.1), y)
    out.update(rand_mean=m_r, rand_cov=K_r, dense_m=post_dense.mean(xq), dense_v=post_dense.var(xq))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def run(request, inputs, tmp_path_factory):
    p = request.param
    port = spawn("gppp", p, inputs, tmp_path_factory.mktemp("gppp"))
    return p, port, _reference(p, inputs)


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.max(np.abs(want)))


def test_sharded_logpdf_and_its_gradient_on_every_rank(run):
    _, port, ref = run
    for o in port:
        _close(o["lp"], ref["lp"], 1e-10)
        _close(o["grad"], ref["grad"], 1e-8)


def test_sharded_posterior_across_processes(run):
    """Observe f3 sharded, read f1's marginals and covariance and a
    `BlockData` mean of f1 and f2; every rank holds the whole result."""
    _, port, ref = run
    for o in port:
        for key in ("post_m", "post_v", "post_C", "post_mb", "post_C2", "post_v2"):
            _close(o[key], ref[key], 1e-10)
    np.testing.assert_allclose(port[0]["post_m"], ref["dense_m"], atol=1e-8)
    np.testing.assert_allclose(port[0]["post_v"], ref["dense_v"], atol=1e-8)


def test_sharded_chol_matches_the_reference(run):
    _, port, ref = run
    _close(np.concatenate([o["chol"] for o in port]), ref["chol"], 1e-10)


@pytest.mark.parametrize("noise", ["cov_block", "cov_full", "cov_pairs"])
def test_sharded_cov_of_blocks_that_straddle_the_ranks(run, noise):
    """A `BlockData` of 24 points of f1 and 40 of f3: the ranks' rows cut
    across the blocks; diagonal per-point noise, dense noise, and the same
    query given as (name, point) pairs."""
    _, port, ref = run
    want = ref["cov_block" if noise == "cov_pairs" else noise]
    _close(np.concatenate([o[noise] for o in port]), want, 1e-12)


def test_sharded_rand_statistics(run):
    """Each rank returns its rows of the draw; whitened by the dense
    factor, 200 draws are iid N(0, 1) (12 800 values: the bounds are about
    5 standard errors), and a draw is fixed by its generator's seed."""
    _, port, ref = run
    draws = np.concatenate([o["draws"] for o in port], axis=1)
    assert draws.shape == (NUM_DRAWS, N)
    np.testing.assert_array_equal(np.concatenate([o["draw_again"] for o in port]), draws[0])
    L = np.linalg.cholesky(ref["rand_cov"])
    zs = np.linalg.solve(L, (draws - ref["rand_mean"]).T)
    assert abs(zs.mean()) < 0.05
    assert abs(zs.std() - 1.0) < 0.04


def test_no_rank_makes_an_n_by_n_tensor(run):
    """The largest tensor any op makes on a rank, forward and backward of
    `sharded_logpdf` at N = 256, is one slab plus the relayout's padding,
    never the whole N×N covariance."""
    p, port, _ = run
    m_blk = (N_LARGE // p) // B_LARGE
    a2a = p * -(-m_blk // p) * B_LARGE * N_LARGE
    for o in port:
        assert o["largest"] <= max(N_LARGE * N_LARGE // p, a2a) < N_LARGE * N_LARGE

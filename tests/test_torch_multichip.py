"""The chains × rows dry run (`stheno_tpu_torch.multichip.dryrun_multichip`)
in gloo groups of P = 2 (a 2 × 1 grid) and P = 4 (2 × 2) on the CPU, f64,
against the JAX functions that `__graft_entry__.dryrun_multichip` calls, on
a JAX mesh of the same shape from the 8 virtual CPU devices: the pre-step
log-densities and gradients (`big_gp_logpdf`), the GPPP value, dlp/dv and
f1 marginals (`sharded_logpdf`, `sharded_posterior`), the SVGP −ELBO and
its gradients (`svgp_elbo_dp`); the ring against the one-process ring
and the dense logpdf; and the grid's NUTS transition bit for bit against the
port's own `nuts_kernel` over the same chains and seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import stheno_tpu as st
from stheno_tpu import GPPPInput, gppp
from stheno_tpu.graph import GPC
from stheno_tpu.inference import BernoulliLikelihood
from stheno_tpu.inference.svgp import SVGP, svgp_init
from stheno_tpu.parallel import data_mesh, shard_batch, sharded_logpdf, sharded_posterior, svgp_elbo_dp
from stheno_tpu.parallel.big import big_gp_logpdf
from stheno_tpu_torch import multichip as mc
from stheno_tpu_torch.kernels import SEKernel, with_lengthscale
from stheno_tpu_torch.parallel import grid_mesh, multihost, shard_rows
from stheno_tpu_torch.parallel.ring import ring_gp_logpdf
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_dist_ranks import join, start

# the configuration's own size: eight panels, the block-cyclic route
N, BLOCK = mc.N_OBS, mc.BLOCK
TOL = 1e-10


@gppp
def _composite(t):
    f1 = st.GP(t["v"] * st.SEKernel())
    f2 = st.GP(st.Matern32Kernel())
    return dict(f1=f1, f2=f2, f3=f1 + f2)


def _reference(p):
    """The JAX functions of the reference's dry run at the same inputs, on a
    (chains × rows) mesh of p virtual devices."""
    chains_ax, rows = mc.grid_shape(p)
    mesh = Mesh(np.asarray(jax.devices()[:p]).reshape(chains_ax, rows), ("chains", "rows"))
    x = jnp.linspace(-3.0, 3.0, N, dtype=jnp.float64)
    y = jnp.sin(x)

    def logdensity(q):
        k = st.with_lengthscale(st.SEKernel(), jnp.exp(q[0]))
        lp = big_gp_logpdf(mesh, k, x, y, noise=jnp.exp(q[1]), block_size=BLOCK, axis_name="rows")
        return lp - 0.5 * jnp.sum(q * q)

    out = {}
    with mesh:
        lp, g = jax.jit(jax.value_and_grad(logdensity))(jnp.zeros(2))
        out["logp0"], out["grad0"] = float(lp), np.asarray(g)
        xp = jnp.linspace(-2.0, 2.0, 8)

        def gppp_lp(v):
            return sharded_logpdf(mesh, _composite(dict(v=v))(GPPPInput("f3", x), 0.1), y,
                                  block_size=BLOCK)

        def marginals(v):
            fx = _composite(dict(v=v))(GPPPInput("f3", x), 0.1)
            return sharded_posterior(mesh, fx, y, block_size=BLOCK).mean_and_var(GPPPInput("f1", xp))

        lp_g, g_v = jax.jit(jax.value_and_grad(gppp_lp))(jnp.asarray(1.2))
        m1, v1 = jax.jit(marginals)(jnp.asarray(1.2))
        out.update(gppp_lp=float(lp_g), gppp_dlp_dv=float(g_v), m1=np.asarray(m1), v1=np.asarray(v1))
    dmesh = data_mesh(p)
    f_sv = st.GP(st.with_lengthscale(st.SEKernel(), 1.0), gpc=GPC())
    fz = f_sv(jnp.linspace(-3.0, 3.0, 16), 1e-6)
    q0 = svgp_init(fz)
    y01 = (y > 0).astype(jnp.float64)

    def loss(qm, qs, xb, yb):
        return -svgp_elbo_dp(dmesh, SVGP(fz, qm, qs), f_sv(xb, 1e-6), yb, scale=1.0,
                             likelihood=BernoulliLikelihood())

    with dmesh:
        val, (g_mu, g_sqrt) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
            q0.q_mu, q0.q_sqrt, shard_batch(dmesh, x), shard_batch(dmesh, y01))
    out.update(neg_elbo=float(val), svgp_dq_mu=np.asarray(g_mu), svgp_dq_sqrt=np.asarray(g_sqrt))
    out["dense_lp"] = float(st.logpdf(st.GP(st.SEKernel(), gpc=GPC())(x, 0.1), y))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def run(request, tmp_path_factory):
    p = request.param
    ranks = start("multichip", p, {}, tmp_path_factory.mktemp("multichip"))
    ref = _reference(p)  # while the ranks run
    return p, join(ranks), ref


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, rtol=tol, atol=tol)


def test_the_grid_and_the_configuration(run):
    p, port, _ = run
    chains_ax, rows = mc.grid_shape(p)
    assert (chains_ax, rows) == {2: (2, 1), 4: (2, 2)}[p]
    for o in port:
        assert o["mesh"] == {"chains": chains_ax, "rows": rows}
        assert o["chains"] == 2 * chains_ax and o["n"] == N and o["nb"] == N // BLOCK
        assert o["depth"] == 5 and o["svgp_mesh"] == {"data": p}
        # every stage ran its collectives (on the CPU no kernel is launched)
        for stage in ("nuts", "gppp", "ring", "svgp"):
            assert sum(o["collectives"][stage].values()) > 0, stage
            assert sum(o["launches"][stage].values()) == 0, stage
        # the transition's evaluations are broadcast over a rows axis of two
        assert (o["collectives"]["nuts"]["broadcast"] > 0) == (rows > 1)


def test_pre_step_logps_and_grads_against_big_gp_logpdf(run):
    _, port, ref = run
    for o in port:
        _close(o["logps"], np.full(o["chains"], ref["logp0"]))
        _close(o["grads"], np.tile(ref["grad0"], (o["chains"], 1)))


def test_sharded_gppp_against_the_reference(run):
    _, port, ref = run
    for o in port:
        for k in ("gppp_lp", "gppp_dlp_dv", "m1", "v1"):
            _close(o[k], ref[k])


def test_svgp_step_against_svgp_elbo_dp(run):
    _, port, ref = run
    for o in port:
        for k in ("neg_elbo", "svgp_dq_mu", "svgp_dq_sqrt"):
            _close(o[k], ref[k])


def _one_process(fn):
    """`fn(mesh)` on a one-rank gloo group's 1 × 1 grid, in this process."""
    multihost.ensure_group("cpu")
    try:
        return fn(grid_mesh(1, 1, device_type="cpu"))
    finally:
        dist.destroy_process_group()


def _ring(mesh, seed):
    x, y = mc.dryrun_data(torch.float64, "cpu")
    ell = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    lp = ring_gp_logpdf(mesh, with_lengthscale(SEKernel(), ell), shard_rows(mesh, x),
                        shard_rows(mesh, y), 0.1, torch.Generator().manual_seed(seed),
                        num_probes=4, lanczos_iters=6, maxiter=64)
    return lp.item(), torch.autograd.grad(lp, ell)[0].item()


def test_ring_value_against_one_process_and_the_dense_logpdf(run):
    """The grid's ring is the one-process ring at the same probes (1e-10,
    value and dlp/dl, the same on every rank), and lies within five standard
    deviations of its estimate over eight more probe seeds of the dense
    logpdf.  (At the dry run's 4 probes and 6 Lanczos iterations the
    estimate is biased and wide at N = 512, the reference's as the port's,
    so the ring tests' 0.02·|d| + 1 at 32 × 30 does not apply.)"""
    _, port, ref = run
    one, spread = _one_process(lambda mesh: (_ring(mesh, 2), [_ring(mesh, s)[0] for s in range(3, 11)]))
    for o in port:
        _close([o["ring_lp"], o["ring_dlp_dl"]], np.asarray(one))
        assert o["ring_lp"] == port[0]["ring_lp"] and o["ring_dlp_dl"] == port[0]["ring_dlp_dl"]
        assert abs(o["ring_lp"] - ref["dense_lp"]) <= 5.0 * np.std(spread), (o["ring_lp"], ref["dense_lp"])


def test_the_grid_transition_equals_nuts_kernel_bit_for_bit(run):
    """Each rank's chains equal the transition over every chain in its rows
    group bit for bit; where the rows axis has one rank (P = 2), also the
    transition of every chain on one process."""
    p, port, _ = run
    for o in port:
        for k in ("q", "logp", "accept_prob"):
            np.testing.assert_array_equal(o[k], o[f"ref_{k}"])
            np.testing.assert_array_equal(o[k], port[0][k])
        assert np.all(np.isfinite(o["logp"]))
    if mc.grid_shape(p)[1] != 1:
        return
    x, y = mc.dryrun_data(torch.float64, "cpu")
    logps, grads, q, logp, info = _one_process(lambda mesh: mc.nuts_stage(mesh, x, y, port[0]["chains"]))
    for got, k in ((q, "q"), (logp, "logp"), (info.accept_prob, "accept_prob"), (logps, "logps"),
                   (grads, "grads")):
        np.testing.assert_array_equal(got.numpy(), port[0][k])

"""The port's distributed Cholesky tier (`stheno_tpu_torch.parallel`:
`cholesky`, `big`) in gloo groups of P = 2 and 4 on the CPU, against
`stheno_tpu.parallel` on a P-device slice of the 8 virtual CPU devices:
the slab, cyclic and auto factors and their gradients in the sharded K,
the solves with several right-hand sides, logdet, the MvNormal logpdf,
the relayout, the sharded kernel matrix and `big_gp_logpdf` with its
hyperparameter gradient on every rank, and each layout's GEMM FLOPs per
rank.  f64 throughout: 1e-10 relative for factors and values, 1e-8 for
gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import stheno_tpu as st
from stheno_tpu.parallel import (
    big_gp_logpdf,
    distributed_chol_solve,
    distributed_cholesky,
    distributed_cholesky_auto,
    distributed_cholesky_cyclic,
    distributed_logdet_chol,
    distributed_lower_matvec,
    distributed_mvn_logpdf,
    distributed_solve_lower,
    distributed_solve_upper_T,
    rows_mesh,
    shard_rows,
    sharded_kernelmatrix,
)
from stheno_tpu.parallel.cholesky import _cyclic_perm, _pick_cyclic_block, from_cyclic, to_cyclic
from stheno_tpu_torch.parallel import cholesky as port_chol
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_dist_ranks import spawn

N, B = 64, 8
RELAYOUT_BLOCKS = (8, 16)  # m = N/(P·B) = 4, 2 at P = 2; 2, 1 at P = 4
N_FLOPS = 128


def _psd(rng, n):
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(42)
    return dict(
        K=_psd(rng, N), W=rng.normal(size=(N, N)), B=B, Bm=rng.normal(size=(N, 3)),
        v=rng.normal(size=N), m=0.1 * rng.normal(size=N), M=rng.normal(size=(N, N)),
        relayout_blocks=RELAYOUT_BLOCKS, K_flops=_psd(rng, N_FLOPS), B_flops=8,
        K_bad=_psd(rng, 60), x=np.sort(rng.uniform(-5, 5, N)), y=rng.normal(size=N), B_big=16,
        x_flops=np.linspace(-3.0, 3.0, N_FLOPS),
    )


def _reference(p, inp):
    """Everything the port's job computes, by `stheno_tpu.parallel` on
    rows_mesh(P), in one jitted pipeline."""
    mesh = rows_mesh(p)
    K, W, Bm, v = (jnp.asarray(inp[k]) for k in ("K", "W", "Bm", "v"))
    m, M = jnp.asarray(inp["m"]), jnp.asarray(inp["M"])
    x, y = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])
    fns = dict(slab=distributed_cholesky, cyclic=distributed_cholesky_cyclic,
               auto=distributed_cholesky_auto)

    @jax.jit
    def pipeline(K, Bm_sh, v_sh, m_sh, M_sh):
        out = {}
        for name, fn in fns.items():
            f = lambda K, fn=fn: jnp.sum(fn(mesh, K, block_size=B) * W)  # noqa: E731
            out[f"L_{name}"] = fn(mesh, K, block_size=B)
            out[f"f_{name}"], out[f"dK_{name}"] = jax.value_and_grad(f)(K)
        out["L_one_block"] = distributed_cholesky(mesh, K, block_size=N // p)
        L = out["L_slab"]
        out["X"] = distributed_solve_lower(mesh, L, Bm_sh, block_size=B)
        out["x_vec"] = distributed_solve_lower(mesh, L, v_sh, block_size=B)
        out["Xt"] = distributed_solve_upper_T(mesh, L, Bm, block_size=B)
        out["S"] = distributed_chol_solve(mesh, L, Bm_sh, block_size=B)
        out["Lv"] = distributed_lower_matvec(mesh, L, v)
        out["logdet"] = distributed_logdet_chol(mesh, L)
        out["mvn"] = distributed_mvn_logpdf(mesh, K, m_sh, v_sh, block_size=B)
        out["f_solve"], out["dL_solve"] = jax.value_and_grad(
            lambda L: jnp.sum(distributed_chol_solve(mesh, L, Bm_sh, block_size=B) * Bm))(L)
        for Br in RELAYOUT_BLOCKS:
            out[f"cyc_{Br}"] = to_cyclic(mesh, M_sh, Br)
            out[f"back_{Br}"] = from_cyclic(mesh, to_cyclic(mesh, M_sh, Br), Br)
            out[f"cycv_{Br}"] = to_cyclic(mesh, v_sh, Br)
        return out

    @jax.jit
    def big(log_l, noise):
        def lp(log_l, noise):
            k = st.with_lengthscale(st.SEKernel(), jnp.exp(log_l))
            return big_gp_logpdf(mesh, k, x, y, noise, block_size=inp["B_big"])

        Kx = sharded_kernelmatrix(mesh, st.SEKernel(), x, noise=0.1)
        val, g = jax.value_and_grad(lp, argnums=(0, 1))(log_l, noise)
        return Kx, val, jnp.stack(g)

    with mesh:
        out = pipeline(shard_rows(mesh, K), shard_rows(mesh, Bm), shard_rows(mesh, v),
                       shard_rows(mesh, m), shard_rows(mesh, M))
        out["Kx"], out["big_lp"], out["big_grad"] = big(jnp.asarray(0.3), jnp.asarray(0.2))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def run(request, inputs, tmp_path_factory):
    p = request.param
    port = spawn("chol", p, inputs, tmp_path_factory.mktemp("chol"))
    return p, port, _reference(p, inputs)


def _rows(port, key):
    """The ranks' slabs of `key`, stacked in rank order."""
    return np.concatenate([o[key] for o in port])


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.max(np.abs(want)))


def test_the_group_is_the_job(run):
    p, port, _ = run
    assert [(o["rank"], o["world"]) for o in port] == [(r, p) for r in range(p)]


@pytest.mark.parametrize("name", ["slab", "cyclic", "auto", "one_block"])
def test_factor_matches_the_reference_and_numpy(run, inputs, name):
    """`one_block`: the slab factor with one diagonal block per rank."""
    _, port, ref = run
    L = _rows(port, f"L_{name}")
    _close(L, ref[f"L_{name}"], 1e-10)
    _close(L, np.linalg.cholesky(inputs["K"]), 1e-10)
    assert np.all(np.triu(L, 1) == 0)


@pytest.mark.parametrize("name", ["slab", "cyclic", "auto"])
def test_factor_gradient_in_the_sharded_K(run, name):
    """The gradient of Σ L∘W in K: each rank holds its rows of the global
    gradient; the value is invariant."""
    _, port, ref = run
    _close(_rows(port, f"dK_{name}"), ref[f"dK_{name}"], 1e-8)
    for o in port:
        _close(o[f"f_{name}"], ref[f"f_{name}"], 1e-10)


def test_solves_with_several_right_hand_sides(run, inputs):
    _, port, ref = run
    for o in port:  # the solves' results are whole on every rank
        for key in ("X", "x_vec", "Xt", "S"):
            _close(o[key], ref[key], 1e-10)
    assert port[0]["X"].shape == (N, 3) and port[0]["x_vec"].shape == (N,)
    _close(_rows(port, "Lv"), ref["Lv"], 1e-10)
    _close(port[0]["S"], np.linalg.solve(inputs["K"], inputs["Bm"]), 1e-9)


def test_solve_gradient_in_the_sharded_factor(run):
    _, port, ref = run
    _close(_rows(port, "dL_solve"), ref["dL_solve"], 1e-8)
    for o in port:
        _close(o["f_solve"], ref["f_solve"], 1e-10)


def test_logdet_and_mvn_logpdf(run, inputs):
    from scipy.stats import multivariate_normal

    _, port, ref = run
    for o in port:
        _close(o["logdet"], ref["logdet"], 1e-10)
        _close(o["mvn"], ref["mvn"], 1e-10)
    lp = multivariate_normal(inputs["m"], inputs["K"]).logpdf(inputs["v"])
    _close(port[0]["mvn"], lp, 1e-9)


@pytest.mark.parametrize("Br", RELAYOUT_BLOCKS)
def test_relayout_round_trip(run, inputs, Br):
    p, port, ref = run
    perm = _cyclic_perm(N // Br, p)
    M = inputs["M"]
    got = _rows(port, f"cyc_{Br}")
    np.testing.assert_array_equal(got, ref[f"cyc_{Br}"])
    np.testing.assert_array_equal(got, M.reshape(N // Br, Br, N)[perm].reshape(N, N))
    np.testing.assert_array_equal(_rows(port, f"back_{Br}"), M)
    np.testing.assert_array_equal(_rows(port, f"cycv_{Br}"),
                                  inputs["v"].reshape(N // Br, Br)[perm].reshape(N))
    assert np.array_equal(port_chol._cyclic_perm(N // Br, p), perm)


def test_a_one_rank_mesh_runs_the_panel_loop_and_its_collectives(inputs):
    """P = 1 (here a one-rank gloo group in this process, on the card a
    one-rank NCCL group) factors through the same panel loop and
    collectives, not through `ops/chol.py`; only the relayout is the
    identity, as the reference's is."""
    import torch
    import torch.distributed as dist

    from stheno_tpu_torch.parallel import collectives, rows_mesh

    made = not dist.is_initialized()
    mesh = rows_mesh(device_type="cpu")
    try:
        K = torch.as_tensor(inputs["K"])
        collectives.reset_counters()
        for fn in (port_chol.distributed_cholesky, port_chol.distributed_cholesky_cyclic):
            _close(fn(mesh, K, block_size=32).numpy(), np.linalg.cholesky(inputs["K"]), 1e-10)
        calls = {k: c.total for k, c in collectives.COUNTERS.items()}
        assert calls["psum"] == 4 and calls["all_gather"] == 2 and calls["all_to_all"] == 0
        assert port_chol.to_cyclic(mesh, K, 32) is K
    finally:
        if made:
            dist.destroy_process_group()


def test_pick_cyclic_block_makes_the_references_choices():
    for n in (64, 128, 256, 1024, 2048, 4096, 16384, 32768):
        for p in (1, 2, 4, 8):
            for b in (16, 32, 64, 128, 256, 512, 1024):
                assert port_chol._pick_cyclic_block(n, p, b) == _pick_cyclic_block(n, p, b)
                assert port_chol.cyclic_compatible(n, p, b) == (n % b == 0 and (n // b) % p == 0)


def test_bad_shapes_raise(run):
    _, port, _ = run
    assert all("must" in o["bad_shape"] for o in port)


def test_gemm_flops_per_rank(run):
    """The cyclic layout's GEMMs cost ≈ N³/(3P) multiply-adds a rank, the
    contiguous slab's ≈ N³/(2P), on every rank (counted with
    `FlopCounterMode`; the counterparts of the reference's cost-model
    checks), and the default route (`big_gp_logpdf`) takes the cyclic one."""
    p, port, _ = run
    slab, cyclic = N_FLOPS**3 / (2 * p), N_FLOPS**3 / (3 * p)
    for o in port:
        assert 0.85 * slab < o["flops_slab"] / 2 < 1.25 * slab
        assert 0.85 * cyclic < o["flops_cyclic"] / 2 < 1.45 * cyclic + 4 * N_FLOPS**2
        assert o["flops_big"] / 2 < 0.5 * (slab + cyclic) + 6 * N_FLOPS**2


def test_sharded_kernelmatrix_and_matvec(run, inputs):
    _, port, ref = run
    Kx = _rows(port, "Kx")
    _close(Kx, ref["Kx"], 1e-12)
    _close(_rows(port, "Kv"), Kx @ inputs["v"], 1e-12)


def test_big_gp_logpdf_and_its_gradient_on_every_rank(run):
    """The hyperparameter gradient on EVERY rank equals the reference's:
    the check that a differentiable all-reduce with a summing backward
    (`torch.distributed.nn.functional`) fails by a factor of about P."""
    _, port, ref = run
    for o in port:
        _close(o["big_lp"], ref["big_lp"], 1e-10)
        _close(o["big_grad"], ref["big_grad"], 1e-8)

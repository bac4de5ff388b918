"""The rest of the port's distributed tier in gloo groups of P = 2 and 4 on
the CPU: data-parallel SVGP (`svgp_elbo_dp`) against `svgp_elbo` and
against `stheno_tpu.parallel.svgp_elbo_dp` on a P-device data mesh (value
and gradients, and a Bernoulli Adam step), the sharded samplers against
the unsharded ones (`run_nuts_sharded`, `run_smc_sharded`), the
multi-process helpers (`multihost.initialize` from explicit arguments,
`grid_mesh`, `is_host0`, `save_on_host0`), the export list, and the three
entry examples (`entry.big_n_sharded_example`, `matrix_free_example`,
`svgp_data_parallel_example`) at P = 4 with their own checks."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import stheno_tpu as st
import stheno_tpu.parallel as jax_parallel
import stheno_tpu_torch.parallel as port_parallel
from stheno_tpu import GPPPInput, gppp
from stheno_tpu.graph import GPC
from stheno_tpu.inference import BernoulliLikelihood
from stheno_tpu.inference.svgp import SVGP, svgp_elbo, svgp_init
from stheno_tpu.parallel import data_mesh, svgp_elbo_dp
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_dist_ranks import spawn

SVGP_N, SVGP_M, BERN_N, BERN_M, SMC_P = 64, 9, 80, 10, 64
PARAMS = dict(v=1.4, l=0.8, noise=0.2)


@gppp
def _composite(theta):
    f1 = st.GP(theta["v"] * st.with_lengthscale(st.SEKernel(), theta["l"]))
    f2 = st.GP(st.Matern32Kernel())
    return dict(f1=f1, f2=f2, f3=f1 + f2)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(42)
    return dict(
        svgp_x=np.sort(rng.uniform(-3, 3, SVGP_N)), svgp_y=rng.normal(size=SVGP_N),
        svgp_z=np.linspace(-2.5, 2.5, SVGP_M), theta0=dict(v=1.4, l=0.8), svgp_params=PARAMS,
        bern_x=np.sort(rng.uniform(-3, 3, BERN_N)),
        bern_y=(rng.uniform(size=BERN_N) < 0.5).astype(np.float64),
        bern_z=np.linspace(-2.5, 2.5, BERN_M), smc_init=rng.normal(size=(SMC_P, 2)),
        ckpt_dir=str(tmp_path_factory.mktemp("ckpt") / "state"),
    )


def _reference(p, inp):
    """JAX's data-parallel bound and gradient, and one Bernoulli Adam step
    of the single-device bound."""
    mesh = data_mesh(p)
    x, y, z = (jnp.asarray(inp[k]) for k in ("svgp_x", "svgp_y", "svgp_z"))
    q0 = svgp_init(_composite(inp["theta0"])(GPPPInput("f3", z), 1e-9))

    def bound(params):
        f = _composite(dict(v=params["v"], l=params["l"]))
        q = SVGP(f(GPPPInput("f3", z), 1e-9), params["q_mu"], params["q_sqrt"])
        return svgp_elbo_dp(mesh, q, f(GPPPInput("f3", x), params["noise"]), y, scale=2.5)

    params = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    params.update(q_mu=q0.q_mu + 0.1, q_sqrt=q0.q_sqrt + 0.05)
    with mesh:
        val, g = jax.jit(jax.value_and_grad(bound))(params)
    out = {"svgp": np.asarray(val), **{f"svgp_d{k}": np.asarray(g[k]) for k in params}}
    f = st.GP(1.3 * st.with_lengthscale(st.SEKernel(), 0.9), gpc=GPC())
    xb, yb = jnp.asarray(inp["bern_x"]), jnp.asarray(inp["bern_y"])
    fz = f(jnp.asarray(inp["bern_z"]), 1e-9)
    qb = svgp_init(fz)
    pb = dict(q_mu=qb.q_mu, q_sqrt=qb.q_sqrt)
    opt = optax.adam(0.1)
    loss = lambda p_: -svgp_elbo(SVGP(fz, p_["q_mu"], p_["q_sqrt"]), f(xb, 1e-9), yb,  # noqa: E731
                                 likelihood=BernoulliLikelihood())
    v, gb = jax.value_and_grad(loss)(pb)
    upd, _ = opt.update(gb, opt.init(pb))
    out["bern"], out["bern_q_mu"] = np.asarray(v), np.asarray(optax.apply_updates(pb, upd)["q_mu"])
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def run(request, inputs, tmp_path_factory):
    p = request.param
    port = spawn("misc", p, dict(inputs, ckpt_dir=f"{inputs['ckpt_dir']}-{p}"),
                 tmp_path_factory.mktemp("misc"))
    return p, port, _reference(p, inputs)


def test_svgp_elbo_dp_matches_the_single_device_bound_and_the_reference(run):
    """Value to 1e-10 and gradients (hyperparameters, variational
    parameters, noise) to 1e-8 on every rank, against the port's
    single-device bound and JAX's data-parallel one."""
    _, port, ref = run
    for o in port:
        np.testing.assert_allclose(o["svgp_dp"], o["svgp_sd"], rtol=1e-10)
        np.testing.assert_allclose(o["svgp_dp"], ref["svgp"], rtol=1e-10)
        for k in ("v", "l", "noise", "q_mu", "q_sqrt"):
            np.testing.assert_allclose(o[f"svgp_dp_d{k}"], o[f"svgp_sd_d{k}"], rtol=1e-8, atol=1e-10,
                                       err_msg=k)
            np.testing.assert_allclose(o[f"svgp_dp_d{k}"], ref[f"svgp_d{k}"], rtol=1e-8, atol=1e-10,
                                       err_msg=k)


def test_svgp_dp_bernoulli_adam_step(run, inputs):
    p, port, ref = run
    for o in port:
        np.testing.assert_allclose(o["bern_dp"], o["bern_sd"], rtol=1e-10)
        np.testing.assert_allclose(o["bern_dp"], ref["bern"], rtol=1e-10)
        np.testing.assert_allclose(o["bern_dp_q_mu"], o["bern_sd_q_mu"], atol=1e-9)
        np.testing.assert_allclose(o["bern_dp_q_mu"], ref["bern_q_mu"], atol=1e-9)
    np.testing.assert_array_equal(np.concatenate([o["batch_rows"] for o in port]), inputs["bern_x"])


def test_run_nuts_sharded_equals_run_nuts(run):
    """Rank r runs chains [r·C/P, (r+1)·C/P) and they equal those chains of
    the unsharded run (a Gaussian and a GP hyperparameter posterior)."""
    p, port, _ = run
    for key in ("nuts", "gp_nuts"):
        full = port[0][key]
        assert full.shape[0] == 4
        got = np.concatenate([o[f"{key}_sharded"] for o in port])
        np.testing.assert_allclose(got, full, rtol=1e-12, atol=1e-12)
        for o in port:
            np.testing.assert_array_equal(o[key], full)
    np.testing.assert_allclose(np.concatenate([o["nuts_sharded_eps"] for o in port]),
                               port[0]["nuts_eps"], rtol=1e-12)


def test_run_smc_sharded_equals_run_smc(run):
    _, port, _ = run
    full = port[0]["smc"]
    got = np.concatenate([o["smc_sharded"]["particles"] for o in port])
    np.testing.assert_allclose(got, full["particles"], rtol=1e-12, atol=1e-12)
    for o in port:
        for k in ("log_evidence", "num_stages", "beta_history"):
            np.testing.assert_allclose(o["smc_sharded"][k], full[k], rtol=1e-12, atol=1e-12)
    # the posterior N(1/2, 1/2) per dimension, roughly, from 64 particles
    assert np.all(np.abs(full["particles"].mean(0) - 0.5) < 0.3)


def test_multihost_helpers(run):
    """Every rank joined the group from explicit arguments (the harness's
    `multihost.initialize(file://..., P, r)`); a second call is a no-op;
    `grid_mesh` splits the ranks into chains × rows; rank 0 alone writes
    the checkpoint, which every rank reads back."""
    p, port, _ = run
    assert [o["host0"] for o in port] == [True] + [False] * (p - 1)
    for r, o in enumerate(port):
        assert tuple(o["grid_shape"]) == (2, p // 2)
        rows = p // 2
        first = (r // rows) * rows
        assert o["rows_sum"] == sum(range(first, first + rows))
        assert o["chains_index"] == r // rows
        np.testing.assert_array_equal(o["ckpt"], [1.0, 2.0, 3.0])


def test_the_exports_match_the_reference():
    assert sorted(port_parallel.__all__) == sorted(jax_parallel.__all__)
    assert len(port_parallel.__all__) == 31
    for name in port_parallel.__all__:
        assert callable(getattr(port_parallel, name))


@pytest.fixture(scope="module")
def examples(tmp_path_factory):
    return spawn("examples", 4, {"svgp": dict(n_total=20_000, steps=60)},
                 tmp_path_factory.mktemp("examples"))


@pytest.mark.parametrize("name", ["big_n_sharded", "matrix_free", "svgp_data_parallel"])
def test_entry_examples_at_p4(examples, name):
    """Each example ran its own checks on every rank (a failed check raises
    and fails the rank); the ranks agree."""
    first = examples[0][name]
    for o in examples[1:]:
        assert o[name].keys() == first.keys()
        for k, v in o[name].items():
            np.testing.assert_allclose(np.asarray(v, dtype=float), np.asarray(first[k], dtype=float),
                                       rtol=1e-12, err_msg=k)
    if name == "big_n_sharded":
        assert first["err"] < 1e-6 and 0.5 < first["l"] < 2.0
    if name == "matrix_free":
        assert 0.4 < first["l"] < 1.2 and 0.05 < first["noise"] < 0.2
    if name == "svgp_data_parallel":
        assert first["last"] < first["first"] and first["rmse"] < 0.15

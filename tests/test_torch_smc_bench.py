"""The SMC measurement tool (`stheno_tpu_torch.smc_bench`) on the CPU: the
analytic workload's evidence within 0.2 of the closed form at 512
particles; the gp workload's log-likelihood, at fixed particle positions
and the same numpy data, against the reference `logpdf` in f64; a
segmented gp run equal to the fused one bit for bit; the rows' keys those
of the reference script; and the `SMCState` export."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as st
import stheno_tpu.inference.smc as jax_smc
from stheno_tpu import GPPPInput, gppp, logpdf
from stheno_tpu_torch import smc_bench
from stheno_tpu_torch.inference import smc as port_smc
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
N, P = 64, 16


def _reference_keys(metric_start):
    """The keys of one of the reference script's JSON rows."""
    src = (REPO / "scripts" / "smc_bench.py").read_text()
    i = src.index(metric_start)
    block = src[src.rindex("{", 0, i):src.index("\n        }", i)]
    keys = set(re.findall(r'"(\w+)":', block))
    if "smc_gp" in metric_start:  # the segmented run's two more keys
        keys |= {"segment_stages", "seg_s_median"}
    return keys


def test_analytic_evidence_within_its_error():
    rows = smc_bench.main(["analytic", "--device", "cpu", "--p-analytic", "512"])
    (row,) = rows
    assert set(row) == _reference_keys('"metric": "smc_evidence_error_analytic"')
    assert row["particles"] == 512 and row["d"] == 3
    assert abs(row["log_z_err_abs_max"]) <= 0.2 and row["stages"] >= 1
    assert row["log_z_true"] == round(-0.5 * (3 * np.log(2 * np.pi * 1.5) + (0.49 + 1.21 + 0.16) / 1.5), 4)


def test_gp_loglike_matches_the_reference_logpdf():
    """The gp workload's log-likelihood of every particle, f64, against the
    reference `logpdf` of the same model at the same numpy data."""
    loglike, logprior, init, (x, y) = smc_bench.gp_problem(N, P, torch.float64, "cpu")
    with torch.no_grad():
        ours = torch.func.vmap(loglike)(init).numpy()
        prior = torch.func.vmap(logprior)(init).numpy()

    @gppp
    def build(p):
        return dict(f=st.GP(p["v"] * st.with_lengthscale(st.SEKernel(), p["l"])))

    xj, yj = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())

    def ref(q):
        p = dict(v=jnp.exp(q[0]), l=jnp.exp(q[1]), noise=jnp.exp(q[2]))
        return logpdf(build(p)(GPPPInput("f", xj), p["noise"]), yj)

    theirs = np.asarray(jax.vmap(ref)(jnp.asarray(init.numpy())))
    np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-10)
    q = init.numpy()
    np.testing.assert_allclose(prior, -0.5 * (np.sum(q * q, 1) + 3 * np.log(2 * np.pi)), rtol=1e-12)
    # the reference script's data: x from numpy seed 3, sorted on [-4, 4]
    np.testing.assert_array_equal(x.numpy(), np.sort(np.random.default_rng(3).uniform(-4, 4, N)))
    assert init.shape == (P, 3) and float(init.abs().max()) < 3.0


def test_gp_segmented_equals_fused_bit_for_bit():
    problem = smc_bench.gp_problem(N, P, torch.float32, "cpu")
    lz_f, st_f, parts_f, _, segs_f = smc_bench.run_gp(problem, 1)
    lz_s, st_s, parts_s, _, segs_s = smc_bench.run_gp(problem, 1, segment=2)
    assert segs_f == [] and len(segs_s) == -(-st_s // 2)
    assert lz_s == lz_f and st_s == st_f
    np.testing.assert_array_equal(parts_s, parts_f)
    assert np.isfinite(lz_f) and st_f >= 1


def test_gp_rows_have_the_reference_keys():
    rows = smc_bench.main(["gp", "--device", "cpu", "--n", "32", "--p", "8", "--seeds", "1",
                           "--segment", "4"])
    (row,) = rows
    assert set(row) == _reference_keys('"metric": f"smc_gp_evidence_N{N}"')
    assert row["n"] == 32 and row["particles"] == 8 and row["segment_stages"] == 4
    assert np.isfinite(row["log_z"]) and len(row["posterior_medians_v_l_noise"]) == 3


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        smc_bench.main(["analytc", "--device", "cpu"])


def test_smc_state_is_exported_as_the_reference_exports_it():
    assert port_smc.SMCState._fields == jax_smc.SMCState._fields
    s = port_smc.SMCState(*(torch.zeros(()) for _ in port_smc.SMCState._fields))
    assert s.step.shape == () and isinstance(s, tuple)

"""The port's SMC against the JAX package's: the conjugate-Gaussian
evidence and posterior moments of the reference's test (its sizes and
tolerances); systematic resampling given the same uniform, the conditional
ESS and the tempering bisection on the same arrays (indices and β exactly,
the ESS to rtol 1e-12); and a run cut into segments, through a checkpoint,
equal to the whole run bit for bit."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stheno_tpu.inference import smc as js
from stheno_tpu_torch.inference import (
    SMCCheckpoint,
    load_checkpoint,
    run_smc,
    save_checkpoint,
    smc_finished,
    smc_init,
    smc_result,
    smc_segment,
)
from stheno_tpu_torch.inference import smc as ts
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

D, Y = 2, 1.0


def _loglike(q):
    return -0.5 * torch.sum((q - Y) ** 2) - 0.5 * D * math.log(2 * math.pi)


def _logprior(q):
    return -0.5 * torch.sum(q**2) - 0.5 * D * math.log(2 * math.pi)


def test_smc_gaussian_evidence():
    """Prior N(0, 1), likelihood N(y = 1 | q, 1) per dimension: the
    posterior is N(1/2, 1/2) and the evidence N(y; 0, 2) per dimension."""
    init = torch.as_tensor(np.random.default_rng(0).normal(size=(2000, D)))
    res = run_smc(3, _loglike, _logprior, init, num_mcmc=5, hmc_step_size=0.5, hmc_num_steps=8)
    log_Z = D * (-0.5 * np.log(2 * np.pi * 2) - Y**2 / 4)
    p = res.particles.numpy()
    assert p.std() > 0.1  # particles not collapsed
    np.testing.assert_allclose(p.mean(0), [0.5, 0.5], atol=0.1)
    np.testing.assert_allclose(p.std(0), np.sqrt(0.5) * np.ones(2), atol=0.1)
    np.testing.assert_allclose(float(res.log_evidence), log_Z, atol=0.15)
    assert int(res.num_stages) >= 1
    assert float(res.beta_history[int(res.num_stages) - 1]) == 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resampling_and_tempering_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    log_like = rng.normal(size=512) * 30.0 - 100.0
    beta = float(rng.uniform(0.0, 0.5))
    w = np.exp(rng.normal(size=512))
    u = float(rng.uniform())
    # the reference's `_systematic_resample` on the uniform its key would draw
    positions = (jnp.asarray(u) + jnp.arange(512)) / 512
    cum = jnp.cumsum(jnp.asarray(w))
    j_idx = np.asarray(jnp.searchsorted(cum / cum[-1], positions))
    t_idx = ts._systematic_resample(torch.tensor(u, dtype=torch.float64), torch.as_tensor(w), 512)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    for b_new in (beta + 1e-3, 0.5 * (beta + 1.0), 1.0):
        np.testing.assert_allclose(
            float(ts._conditional_ess(torch.as_tensor(log_like), beta, b_new)),
            float(js._conditional_ess(jnp.asarray(log_like), beta, b_new)), rtol=1e-12)
    for frac in (0.3, 0.5, 0.9):
        j_beta = float(js._next_beta(jnp.asarray(log_like), jnp.asarray(beta), frac, 512))
        t_beta = float(ts._next_beta(torch.as_tensor(log_like), torch.tensor(beta, dtype=torch.float64),
                                     frac, 512))
        assert t_beta == j_beta, (frac, t_beta, j_beta)


def test_systematic_resample_matches_the_reference_function():
    """The reference's `_systematic_resample` with its key against the
    port's given the uniform that key draws."""
    import jax

    rng = np.random.default_rng(5)
    w = np.exp(rng.normal(size=300))
    key = jax.random.PRNGKey(7)
    j_idx = np.asarray(js._systematic_resample(key, jnp.asarray(w), 300))
    u = float(jax.random.uniform(key, ()))
    t_idx = ts._systematic_resample(torch.tensor(u, dtype=torch.float64), torch.as_tensor(w), 300)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)


def test_segmented_equals_fused(tmp_path):
    init = torch.as_tensor(np.random.default_rng(1).normal(size=(256, D)))
    kw = dict(num_mcmc=2, hmc_step_size=0.5, hmc_num_steps=4, ess_target=0.95)
    fused = run_smc(9, _loglike, _logprior, init, **kw)
    assert int(fused.num_stages) >= 3  # so that the segments below cut the run
    state = smc_init(_loglike, _logprior, init)
    segments = 0
    while not smc_finished(state):
        state = smc_segment(9, _loglike, _logprior, init, state, 2, **kw)
        path = str(tmp_path / f"smc_{segments}")
        save_checkpoint(path, state, step=int(state.step))
        state = SMCCheckpoint(*load_checkpoint(path, state))
        segments += 1
    assert segments >= 2
    res = smc_result(state, init)
    for a, b in zip(res, fused):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # a segment past the end is a no-op
    again = smc_segment(9, _loglike, _logprior, init, state, 3, **kw)
    for a, b in zip(again, state):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_pytree_particles():
    init = {"b": torch.as_tensor(np.random.default_rng(2).normal(size=(500, 1))),
            "a": torch.as_tensor(np.random.default_rng(3).normal(size=(500,)))}

    def loglike(p):
        return -0.5 * ((p["a"] - Y) ** 2 + torch.sum((p["b"] - Y) ** 2))

    def logprior(p):
        return -0.5 * (p["a"] ** 2 + torch.sum(p["b"] ** 2))

    res = run_smc(4, loglike, logprior, init, num_mcmc=3, hmc_step_size=0.5, hmc_num_steps=8)
    assert res.particles["a"].shape == (500,) and res.particles["b"].shape == (500, 1)
    np.testing.assert_allclose(float(res.particles["a"].mean()), 0.5, atol=0.15)
    np.testing.assert_allclose(float(res.particles["b"].mean()), 0.5, atol=0.15)

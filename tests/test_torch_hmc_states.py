"""Sampling in the port from states the JAX package adapted, carried
across by `convert.chain_state_from_numpy` and `warmup_state_from_numpy`:
the posterior moments agree with the reference's draws within Monte Carlo
error, and the carried warmup state is the reference's, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stheno_tpu.inference import hmc as jh
from stheno_tpu_torch.convert import chain_state_from_numpy, warmup_state_from_numpy
from stheno_tpu_torch.inference import nuts_warmup, run_nuts, warmup_result
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _std_normal(q):
    return -0.5 * torch.sum(q**2)


def test_sampling_from_a_jax_adapted_state_matches_the_reference():
    """The reference adapts 4 chains on a correlated Gaussian and samples
    600 draws a chain; the port samples 600 more from the reference's final
    state.  Their means and covariances agree within Monte Carlo error (5
    standard errors of the pooled draws, counting an ESS of half the draws;
    the draws themselves differ, the generators do)."""
    cov = np.array([[4.0, 1.8], [1.8, 1.0]])
    prec = np.linalg.inv(cov)

    def j_logp(q):
        return -0.5 * q @ jnp.asarray(prec) @ q

    def t_logp(q):
        return -0.5 * q @ torch.as_tensor(prec) @ q

    j_draws, _, j_state = jh.run_nuts(jax.random.PRNGKey(0), j_logp, jnp.zeros(2), num_warmup=300,
                                      num_samples=600, num_chains=4, return_state=True)
    t_state = chain_state_from_numpy(j_state, device="cpu")
    t_draws, t_info = run_nuts(0, t_logp, torch.zeros(2, dtype=torch.float64), num_samples=600,
                               num_chains=4, resume_state=t_state)
    np.testing.assert_array_equal(t_info.step_size[:, 0].numpy(), np.asarray(j_state.eps))
    a, b = t_draws.reshape(-1, 2).numpy(), np.asarray(j_draws).reshape(-1, 2)
    se = np.sqrt(np.diag(cov) / (len(a) / 2))
    np.testing.assert_array_less(np.abs(a.mean(0) - b.mean(0)), 5 * np.sqrt(2) * se)
    np.testing.assert_allclose(np.cov(a.T), np.cov(b.T), rtol=0.2, atol=0.1)
    np.testing.assert_allclose(np.cov(a.T), cov, rtol=0.15, atol=0.1)


def test_warmup_state_carries_across_from_the_reference():
    key = jax.random.PRNGKey(1)
    j_state = jh.nuts_warmup(key, lambda q: -0.5 * jnp.sum(q**2), jnp.zeros(3), num_warmup=30,
                             num_chains=2)
    t_state = warmup_state_from_numpy(j_state, device="cpu")
    np.testing.assert_array_equal(t_state.da.log_eps_avg.numpy(), np.asarray(j_state.da.log_eps_avg))
    np.testing.assert_array_equal(t_state.wf.m2.numpy(), np.asarray(j_state.wf.m2))
    np.testing.assert_array_equal(warmup_result(t_state).eps.numpy(),
                                  np.asarray(jh.warmup_result(j_state).eps))
    # the port's warmup goes on from it
    st = nuts_warmup(0, _std_normal, torch.zeros(3, dtype=torch.float64), num_warmup=40,
                     num_chains=2, segment=(30, 40), state=t_state)
    assert st.q.shape == (2, 3) and bool(torch.isfinite(st.q).all())

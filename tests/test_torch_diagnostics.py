"""The port's sampler diagnostics against the JAX package's: split-R̂ and
bulk ESS on the same (C, S) and (C, S, D) arrays, made with numpy from a
seed.  Tolerance: rtol 1e-12 in f64 (the same arithmetic, step for step;
only the FFT's and the reductions' rounding may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stheno_tpu.inference import diagnostics as jd
from stheno_tpu_torch.inference import diagnostics as td
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _chains(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "iid":
        return rng.normal(size=shape)
    if kind == "ar":
        # strongly autocorrelated chains, each offset a little (R̂ > 1)
        x = np.zeros(shape)
        noise = rng.normal(size=shape)
        for t in range(1, shape[1]):
            x[:, t] = 0.95 * x[:, t - 1] + 0.3 * noise[:, t]
        return x + 0.2 * np.arange(shape[0]).reshape((-1,) + (1,) * (len(shape) - 1))
    # antithetic: negative lag-1 correlation, ESS above C·S before the cap
    x = rng.normal(size=shape)
    x[:, 1::2] = -0.8 * x[:, 0::2][:, : x[:, 1::2].shape[1]] + 0.2 * x[:, 1::2]
    return x


@pytest.mark.parametrize("kind", ["iid", "ar", "antithetic"])
@pytest.mark.parametrize("shape", [(4, 1000), (3, 201), (4, 300, 3)], ids=["4x1000", "3x201", "4x300x3"])
def test_rhat_and_ess_equal_the_reference(kind, shape):
    x = _chains(kind, shape, seed=sum(shape))
    for fn in ("potential_scale_reduction", "effective_sample_size"):
        ref = np.asarray(getattr(jd, fn)(jnp.asarray(x)))
        got = getattr(td, fn)(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, err_msg=fn)


def test_split_chains_and_autocov_equal_the_reference():
    x = np.random.default_rng(5).normal(size=(3, 41))
    np.testing.assert_array_equal(td.split_chains(torch.as_tensor(x)).numpy(),
                                  np.asarray(jd.split_chains(jnp.asarray(x))))
    np.testing.assert_allclose(td._autocov(torch.as_tensor(x)).numpy(),
                               np.asarray(jd._autocov(jnp.asarray(x))), rtol=1e-12, atol=1e-15)


def test_ess_is_nan_below_four_draws_per_half_chain():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(2, 6)))
    assert bool(torch.isnan(td.effective_sample_size(x)))
    assert np.isnan(float(jd.effective_sample_size(jnp.asarray(x.numpy()))))


def test_iid_and_autocorrelated_behave():
    """The reference test's expectations: ESS of iid draws near C·S and R̂
    near 1; strongly autocorrelated chains have a low ESS."""
    x = torch.as_tensor(_chains("iid", (4, 1000), 1))
    assert float(td.effective_sample_size(x)) > 2000
    np.testing.assert_allclose(float(td.potential_scale_reduction(x)), 1.0, atol=0.02)
    ar = np.zeros((4, 1000))
    noise = np.random.default_rng(2).normal(size=(4, 1000))
    for t in range(1, 1000):
        ar[:, t] = 0.99 * ar[:, t - 1] + 0.1 * noise[:, t]
    assert float(td.effective_sample_size(torch.as_tensor(ar))) < 500

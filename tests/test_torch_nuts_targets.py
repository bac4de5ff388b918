"""The port's counterparts of the reference's NUTS tests on a correlated
anisotropic Gaussian and on pytree positions (`tests/test_inference.py:
43-73`), with the same tolerances and the same number of draws, spread
over more and shorter chains (a transition costs the port about 1 ms a
leapfrog on the CPU whatever the batch), after a warmup of 200 iterations
where the reference takes 300 and 500: Stan's windows still fit (75 + 25 +
50 + the last window's remainder), and the host time is the warmup's."""

import numpy as np
import torch

from stheno_tpu_torch.inference import potential_scale_reduction, run_nuts
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def test_nuts_correlated_gaussian():
    cov = np.array([[4.0, 1.8], [1.8, 1.0]])
    prec = torch.as_tensor(np.linalg.inv(cov))
    samples, _ = run_nuts(1, lambda q: -0.5 * q @ prec @ q, torch.zeros(2, dtype=torch.float64),
                          num_warmup=200, num_samples=250, num_chains=16)
    s = samples.reshape(-1, 2).numpy()
    assert s.shape == (4000, 2)
    np.testing.assert_allclose(np.cov(s.T), cov, rtol=0.15, atol=0.1)
    assert float(potential_scale_reduction(samples[..., 0])) < 1.02


def test_nuts_pytree_positions():
    def logp(q):
        return -0.5 * torch.sum(q["a"] ** 2) - 0.5 * torch.sum((q["b"] - 1.0) ** 2)

    init = dict(a=torch.zeros(2, dtype=torch.float64), b=torch.zeros(3, dtype=torch.float64))
    samples, _ = run_nuts(2, logp, init, num_warmup=200, num_samples=250, num_chains=4)
    assert samples["a"].shape == (4, 250, 2) and samples["b"].shape == (4, 250, 3)
    np.testing.assert_allclose(samples["b"].mean((0, 1)).numpy(), np.ones(3), atol=0.15)

"""The port's counterparts of the reference's statistical NUTS and HMC
tests (`tests/test_inference.py:21-93`), with the same tolerances and the
same number of draws: a 5-D standard normal, and plain HMC on a 3-D one
(over 16 shorter chains: a transition costs the port about 1 ms of host
time a leapfrog on the CPU whatever the batch).  The correlated Gaussian
and the pytree positions are in `test_torch_nuts_targets.py`."""

import numpy as np
import torch

from stheno_tpu_torch.inference import run_nuts
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def test_nuts_standard_normal():
    """At the reference's sizes: more chains make its warmup dearer here
    (a batch waits for its longest trajectory, and a 5-D standard normal
    at ε ≈ √2 has periodic orbits that run to the depth limit)."""
    d = 5
    samples, info = run_nuts(0, lambda q: -0.5 * torch.sum(q**2), torch.zeros(d, dtype=torch.float64),
                             num_warmup=400, num_samples=800, num_chains=4)
    s = samples.reshape(-1, d).numpy()
    assert s.shape == (3200, d)
    np.testing.assert_allclose(s.mean(0), np.zeros(d), atol=0.1)
    np.testing.assert_allclose(s.std(0), np.ones(d), atol=0.1)
    assert info.diverging.double().mean() < 0.01
    acc = info.accept_prob.mean().item()
    assert 0.6 < acc <= 1.0


def test_hmc_kernel_standard_normal():
    """Plain HMC has a fixed path length L·ε: where the adapted ε puts it
    near a whole number of periods of the Gaussian (2π), a chain barely
    moves, in the reference as here (its key adapts one chain to 1.93
    periods).  Seed 4 adapts the chains to 1.87–2.20 periods."""
    samples, _ = run_nuts(4, lambda q: -0.5 * torch.sum(q**2), torch.zeros(3, dtype=torch.float64),
                          num_warmup=300, num_samples=200, num_chains=16, kernel="hmc",
                          num_hmc_steps=16)
    s = samples.reshape(-1, 3).numpy()
    assert s.shape == (3200, 3)
    np.testing.assert_allclose(s.mean(0), np.zeros(3), atol=0.12)
    np.testing.assert_allclose(s.std(0), np.ones(3), atol=0.12)

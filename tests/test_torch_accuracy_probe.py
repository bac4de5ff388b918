"""The accuracy probe's routes (`stheno_tpu_torch.accuracy_probe`) on the CPU:
each scopes what it names and undoes it, and the one-GEMM update it swaps
in computes the same factor as the port's panel-by-panel update (f64,
1e-12 relative, both against `torch.linalg.cholesky`)."""

import numpy as np
import pytest
import torch

import stheno_tpu_torch as stt
from stheno_tpu_torch import accuracy_probe
from stheno_tpu_torch.ops import blocked_cholesky as bc
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3.0, 3.0, n))
    K = np.exp(-0.5 * np.subtract.outer(x, x) ** 2 / 0.3**2) + 1e-2 * np.eye(n)
    return torch.as_tensor(K)


@pytest.mark.parametrize("name", accuracy_probe.ROUTES)
def test_each_route_scopes_its_factor_and_undoes_it(name):
    kept = bc._left_update
    with accuracy_probe.route(name):
        backend = stt.config.active_override("chol_backend", "auto")
        bases = stt.config.active_override("base_cholesky", None)
        swapped = bc._left_update is not kept
    assert backend == ("torch" if name == "cusolver" else "blocked")
    assert (bases is bc.torch_chol_lower) == (name == "library_bases")
    assert swapped == (name == "one_gemm")
    assert bc._left_update is kept
    assert stt.config.active_override("chol_backend", "auto") == "auto"


def test_one_gemm_update_computes_the_same_factor():
    """n = 1024 with panels of 256: three earlier panels in the last update,
    and the inner recursion's own updates."""
    K = _spd(1024, 0)
    want = torch.linalg.cholesky(K)
    with accuracy_probe.route("port"):
        panel = bc._blocked_cholesky_impl(K, block=256, base=64)
    with accuracy_probe.route("one_gemm"):
        one = bc._blocked_cholesky_impl(K, block=256, base=64)
    for L in (panel, one):
        torch.testing.assert_close(L, want, rtol=1e-12, atol=1e-12 * want.abs().max().item())

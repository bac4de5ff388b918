"""The port's examples (`stheno_tpu_torch.examples`) on the CPU in f64:

- every port example runs with its own checks at `fast=True` (smaller
  counts where the example's own make the test slow; never a smaller
  model, other data or a looser check);
- `EXAMPLES` names a port function for every file of `examples/`.

Their models against the JAX examples' are in `test_torch_examples_parity.py`,
and rows 5 and 6 (the user-defined processes) in `test_torch_extension.py`.
"""

import importlib
from pathlib import Path

import pytest

from stheno_tpu_torch.examples import ENTRY_FUNCTIONS, MODULES
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent

#: counts that only shorten a run, for the ones whose own make this file slow
SMALL = {
    "deep_kernel_learning": dict(num_steps=200),
    "getting_started": dict(nm_maxiter=100, bfgs_maxiter=60, num_warmup=40, num_samples=60),
    "markov_time_series": dict(n=8000),
    "non_gaussian_likelihoods": dict(evidence_steps=20, svgp_steps=100),
}


@pytest.mark.parametrize("name", MODULES)
def test_every_port_example_runs_with_its_checks(name):
    out = importlib.import_module(f"stheno_tpu_torch.examples.{name}").main(device="cpu", fast=True, **SMALL.get(name, {}))
    assert isinstance(out, dict) and out


def test_examples_maps_every_example_file():
    from stheno_tpu_torch.examples import EXAMPLES

    stems = {p.stem for p in (REPO / "examples").glob("*.py")}
    assert set(EXAMPLES) == stems
    assert set(MODULES) | set(ENTRY_FUNCTIONS) == stems and not set(MODULES) & set(ENTRY_FUNCTIONS)
    assert all(callable(fn) for fn in EXAMPLES.values())

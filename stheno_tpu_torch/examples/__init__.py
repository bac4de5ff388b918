"""The programmes of `examples/` on the port.

Ten of them are modules here, one per JAX example and under its file
name, each with `main(device="cuda", fast=False, **counts) -> dict`,
which runs the example's sections in order with its checks (raised as
`RuntimeError`) and returns the numbers it printed:

    python -m stheno_tpu_torch.examples.sensor_fusion [--device cpu] [--fast]

The other ten run as functions of `entry` (and, for the distributed
three, on the ranks of a mesh).  `EXAMPLES` maps every file name of
`examples/` to the port function that runs it.  Each runs on `cuda`
unless given `device="cpu"`.

The modules draw their random numbers from CPU `torch.Generator`s seeded
with the reference's key numbers (JAX's draws cannot be reproduced), so
the card draws what the CPU tests draw, and an example's checks meet the
same data on both.

The modules are imported when `EXAMPLES` is first read, not with the
package: `python -m` of one example imports only that one.
"""

from __future__ import annotations

import importlib

#: the examples that are modules of this package
MODULES = (
    "convolutional_gp",
    "custom_affine_transformations",
    "deep_kernel_learning",
    "getting_started",
    "markov_time_series",
    "naive_linear_mixing",
    "non_gaussian_likelihoods",
    "process_decomposition",
    "sensor_fusion",
    "time_varying_blr",
)

#: the examples that `entry` runs, by the name of its function
ENTRY_FUNCTIONS = {
    "big_n_sharded": "big_n_sharded_example",
    "differentiation": "differentiation_example",
    "extended_mauna_loa": "mauna_loa_example",
    "gppp_and_pseudo_points": "pseudo_points_example",
    "matrix_free_big_n": "matrix_free_example",
    "neural_kernel_network": "nkn_example",
    "nuts_hyperparameters": "nuts_example",
    "quadrature_convolution": "quadrature_convolution_example",
    "smc_model_evidence": "smc_example",
    "svgp_data_parallel": "svgp_data_parallel_example",
}


def _examples():
    from stheno_tpu_torch import entry

    out = {name: importlib.import_module(f"{__name__}.{name}").main for name in MODULES}
    out.update({name: getattr(entry, fn) for name, fn in ENTRY_FUNCTIONS.items()})
    return dict(sorted(out.items()))


def __getattr__(name):
    if name == "EXAMPLES":
        globals()["EXAMPLES"] = examples = _examples()
        return examples
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

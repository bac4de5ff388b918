"""Model families: the five BASELINE workloads as parametric `@gppp` functions
(counterpart of `stheno_tpu/models/`)."""

from stheno_tpu_torch.models.workloads import (
    WORKLOADS,
    hyperparameter_model,
    mauna_loa_style,
    process_decomposition,
    pseudo_points_model,
    sensor_fusion,
)

__all__ = [
    "process_decomposition", "sensor_fusion", "mauna_loa_style",
    "pseudo_points_model", "hyperparameter_model", "WORKLOADS",
]

"""What a programme's adapter hands the `fit` driver."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class FitProblem(NamedTuple):
    """The flat unconstrained θ₀, the objective of θ, and the name of the
    harness's span around the objective."""

    theta0: torch.Tensor
    objective: Callable
    span: str


def dtype(cfg):
    """The configuration's stated dtype."""
    return DTYPES[cfg["dtype"]]

"""What the port's examples share: the check that raises, the f64 tensor
of a numpy array on the run's device, and the command line.

    python -m stheno_tpu_torch.examples.<name> [--device cpu] [--fast]

runs an example's `main` on the card (or on the CPU with `--device cpu`)
and prints the numbers it returns as one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from stheno_tpu_torch.entry import _check as check  # noqa: F401  (re-exported)

F64 = torch.float64


def tensor(a, dev, dtype=F64):
    """`a` (a numpy array or a number) as a tensor of `dtype` on `dev`."""
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


def numpy(t):
    """A tensor as a numpy array on the host."""
    return t.detach().cpu().numpy()


def run_cli(main, description):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default="cuda",
                        help="the device to run on (default cuda; cpu runs the plain kernels)")
    parser.add_argument("--fast", action="store_true",
                        help="the example's shorter counts (every section and check still runs)")
    args = parser.parse_args()
    out = main(device=args.device, fast=args.fast)
    print(json.dumps(out, default=float))

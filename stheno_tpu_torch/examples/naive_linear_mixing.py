"""Naive linear mixing (`examples/naive_linear_mixing.py`) on the port:
three outputs, fixed linear mixes of two latent processes, observed at
10, 4 and 7 points and conditioned jointly; every output and latent gets
a posterior.

    python -m stheno_tpu_torch.examples.naive_linear_mixing [--device cpu]

The observations are a draw from a CPU `torch.Generator` seeded 123456, the
reference's key number; the inputs come from numpy's `default_rng(123456)`.
"""

from __future__ import annotations

import numpy as np
import torch

from stheno_tpu_torch import BlockData, GPPPInput, marginals, posterior, rand, split
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.examples._common import check, run_cli, tensor
from stheno_tpu_torch.gppp import gppp
from stheno_tpu_torch.graph import GP
from stheno_tpu_torch.kernels import SEKernel, with_lengthscale

NOISE = 0.1
#: each output's weights on (f1, f2)
MIXES = {"g1": (0.2, 0.8), "g2": (0.3, 0.7), "g3": (0.9, 0.2)}


@gppp
def model():
    f1 = GP(SEKernel())
    f2 = GP(with_lengthscale(SEKernel(), 0.1))
    gs = {name: a * f1 + b * f2 for name, (a, b) in MIXES.items()}
    return dict(f1=f1, f2=f2, **gs)


def data(dev):
    """The ragged inputs: 10, 4 and 7 normal draws for g1, g2 and g3."""
    rng = np.random.default_rng(123456)
    return BlockData(*(GPPPInput(name, tensor(rng.normal(size=n), dev))
                       for name, n in zip(MIXES, (10, 4, 7))))


def query(dev):
    """Every process at 300 points of [−5, 5]."""
    xp = torch.linspace(-5.0, 5.0, 300, dtype=torch.float64, device=dev)
    return BlockData(*(GPPPInput(name, xp) for name in ("f1", "f2", *MIXES)))


def main(device="cuda", fast=False):
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(123456)
    f = model()
    x = data(dev)
    fx = f(x, NOISE)
    y = rand(gen, fx)
    post = posterior(fx, y)
    xp_all = query(dev)
    ms = marginals(post(xp_all, 1e-9))
    mf1, mf2, *mgs = split(xp_all, ms.mean)

    out = {}
    for (name, (a, b)), mg in zip(MIXES.items(), mgs):
        err = (a * mf1 + b * mf2 - mg).abs().max().item()
        out[f"mixing_err_{name}"] = err
        check(err < 1e-8, f"{name} mixing inconsistent: {err}")
    print("posterior mixing identities: OK")

    # conditioning on the outputs shrinks the latent f1's variance below its
    # prior variance (1) inside the data
    vf1 = split(xp_all, ms.var)[0]
    inside = xp_all.blocks[0].x.abs() < 2.0
    out["f1_var_inside"] = vf1[inside].mean().item()
    check(out["f1_var_inside"] < 0.8, f"latent f1 variance inside the data {out['f1_var_inside']}")
    print(f"latent f1 posterior var inside data: {out['f1_var_inside']:.3f} (prior 1.0)")
    print("naive_linear_mixing: OK")
    return out


if __name__ == "__main__":
    run_cli(main, __doc__)

"""Process decomposition (`examples/process_decomposition.py`, BASELINE #1)
on the port: f3 = f1 + f2, data drawn from f3, and the joint posterior over
all three processes, the latent f1 and f2 included.

    python -m stheno_tpu_torch.examples.process_decomposition [--device cpu]

The observations are a prior draw from a CPU `torch.Generator` seeded 4, the
reference's key number (its JAX draw cannot be reproduced).
"""

from __future__ import annotations

import numpy as np
import torch

from stheno_tpu_torch import BlockData, GPPPInput, logpdf, marginals, posterior, rand, split
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.examples._common import check, run_cli, tensor
from stheno_tpu_torch.gppp import gppp
from stheno_tpu_torch.graph import GP
from stheno_tpu_torch.kernels import SEKernel, with_lengthscale

NOISE = 0.05


@gppp
def model():
    f1 = GP(SEKernel())
    f2 = GP(with_lengthscale(SEKernel(), 0.5))
    return dict(f1=f1, f2=f2, f3=f1 + f2)


def data(dev):
    """The example's 21 inputs, sorted uniform on [−5, 5] (numpy, seed 0)."""
    return tensor(np.sort(np.random.default_rng(0).uniform(-5.0, 5.0, 21)), dev)


def query(dev):
    """f1, f2 and f3 jointly at 121 points of [−6, 6]."""
    xp = torch.linspace(-6.0, 6.0, 121, dtype=torch.float64, device=dev)
    return BlockData(GPPPInput("f1", xp), GPPPInput("f2", xp), GPPPInput("f3", xp))


def main(device="cuda", fast=False):
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(4)
    f = model()
    fx = f(GPPPInput("f3", data(dev)), NOISE)
    y = rand(gen, fx)
    out = {"n": len(y), "logpdf": logpdf(fx, y).item()}
    print(f"observations: N={len(y)}, y[:4]={np.round(y[:4].tolist(), 3)}")
    print(f"prior logpdf(f3(x), y) = {out['logpdf']:.4f}")

    post = posterior(fx, y)
    xp_all = query(dev)
    ms = marginals(post(xp_all, 1e-9))
    m1, m2, m3 = split(xp_all, ms.mean)
    s1, s2, s3 = split(xp_all, ms.std)
    for name, m, s in (("f1", m1, s1), ("f2", m2, s2), ("f3", m3, s3)):
        out[f"mean_{name}_at_0"], out[f"std_{name}_at_0"] = m[60].item(), s[60].item()
        print(f"posterior mean over {name} at x=0: {m[60].item():.4f} ± {s[60].item():.4f}")
    out["additivity_err"] = (m1 + m2 - m3).abs().max().item()
    print(f"additivity |m1 + m2 - m3|_inf = {out['additivity_err']:.2e}")
    check(out["additivity_err"] < 1e-6, f"additivity of the means {out['additivity_err']}")

    ys = rand(gen, post(xp_all, 1e-9), 5)
    y1, y2, y3 = split(xp_all, ys)
    out["sample_additivity_err"] = (y1 + y2 - y3).abs().max().item()
    print(f"sample additivity err = {out['sample_additivity_err']:.2e}")
    check(out["sample_additivity_err"] < 1e-3,
          f"additivity of the samples {out['sample_additivity_err']}")
    print("process_decomposition: OK")
    return out


if __name__ == "__main__":
    run_cli(main, __doc__)

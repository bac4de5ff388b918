"""Deep kernel learning (`examples/deep_kernel_learning.py`) on the port: a
neural feature map (an MLP, 1 → 16 → 16 → 4 with tanh) feeding an SE
kernel, its weights and the GP's hyperparameters trained jointly by the
exact marginal likelihood.

The MLP is an `nn.Module` run by `torch.func.functional_call` on a dict of
weight tensors, so the kernel is v·TransformedKernel(SE, ParamFn(apply, w)):
the weights are plain leaves of the spec, which `params` and
`inference.fit` train beside the constrained v and noise.  Kernel 1 runs
on the 4-dimensional features.  Its layers are named as flax names them
(`Dense_0`, ...), so `convert.mlp_from_numpy` carries flax's weights over.

    python -m stheno_tpu_torch.examples.deep_kernel_learning [--device cpu] [--fast]

The initial weights are drawn from a CPU `torch.Generator` seeded 0, the
reference's key number, with flax's `Dense` law (normal of variance
1/fan-in, not truncated; zero biases), so every device starts from the
same weights; the data come from numpy's `default_rng(0)`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from stheno_tpu_torch import GPPPInput, TransformedKernel, logpdf, marginals, posterior
from stheno_tpu_torch import params as P
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.examples._common import check, run_cli, tensor
from stheno_tpu_torch.gppp import gppp
from stheno_tpu_torch.graph import GP, ParamFn
from stheno_tpu_torch.inference import fit
from stheno_tpu_torch.kernels import SEKernel

WIDTHS = (1, 16, 16, 4)


class FeatureNet(torch.nn.Module):
    """The MLP feature map R → R⁴."""

    def __init__(self):
        super().__init__()
        for i, (a, b) in enumerate(zip(WIDTHS[:-1], WIDTHS[1:])):
            setattr(self, f"Dense_{i}", torch.nn.Linear(a, b, device="meta"))

    def forward(self, x):
        h = x[:, None] if x.dim() == 1 else x
        h = torch.tanh(self.Dense_0(h))
        h = torch.tanh(self.Dense_1(h))
        return self.Dense_2(h)


NET = FeatureNet()


def apply(w, x):
    """The features of x under the weights `w`."""
    return torch.func.functional_call(NET, w, (x,))


def init_weights(gen, dtype=torch.float64, device="cuda"):
    """Weights drawn from the `torch.Generator` `gen` on its own device and
    moved to `device`: normal of variance 1/fan-in for each layer's matrix,
    zero biases."""
    w = {}
    for i, (a, b) in enumerate(zip(WIDTHS[:-1], WIDTHS[1:])):
        draw = torch.randn(b, a, generator=gen, dtype=dtype, device=gen.device) / a**0.5
        w[f"Dense_{i}.weight"] = draw.to(device)
        w[f"Dense_{i}.bias"] = torch.zeros(b, dtype=dtype, device=device)
    return w


@gppp
def build(p):
    k = p["v"] * TransformedKernel(SEKernel(), ParamFn(apply, p["w"]))
    return dict(f=GP(k))


def nlml(p, x, y):
    return -logpdf(build(p)(GPPPInput("f", x), p["noise"]), y)


def data(n=120, dtype=torch.float64, device="cuda"):
    """Step-function-like data, hard for a stationary kernel and easy for a
    learned warp: x sorted uniform on [−3, 3], y = sign(x) + 0.1·noise
    (numpy, seed 0)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-3, 3, n))
    y = np.sign(x) + 0.1 * rng.normal(size=n)
    return tensor(x, dev, dtype), tensor(y, dev, dtype)


def spec(w, dtype=torch.float64, device="cuda"):
    """The example's spec: the weights free, v and the noise positive at 1.0
    and 0.2."""
    return dict(w=w, v=P.positive(torch.tensor(1.0, dtype=dtype, device=device)),
                noise=P.positive(torch.tensor(0.2, dtype=dtype, device=device)))


def main(device="cuda", fast=False, num_steps=600):
    dev = resolve_device(device)
    x, y = data(device=dev)
    w0 = init_weights(torch.Generator().manual_seed(0), device=dev)
    t0 = time.time()
    res = fit(lambda p: nlml(p, x, y), spec(w0, device=dev), num_steps=num_steps,
              learning_rate=1e-2)
    out = {"fit_s": time.time() - t0, "nlml_first": res.losses[0].item(),
           "nlml_last": res.losses[-1].item()}
    print(f"joint NN+GP fit: {out['fit_s']:.1f}s  nlml {out['nlml_first']:.1f} → "
          f"{out['nlml_last']:.1f}")
    check(out["nlml_last"] < out["nlml_first"] - 20, f"the fit made too little progress: {out}")

    p = res.params
    with torch.no_grad():
        post = posterior(build(p)(GPPPInput("f", x), p["noise"]), y)
        xp = torch.linspace(-2.5, 2.5, 201, dtype=torch.float64, device=dev)
        ms = marginals(post(GPPPInput("f", xp), 1e-9))
    away = xp.abs() > 0.3
    out["sign_accuracy"] = (torch.sign(ms.mean[away]) == torch.sign(xp[away])).double().mean().item()
    print(f"sign accuracy away from the step: {out['sign_accuracy']:.2%}")
    check(out["sign_accuracy"] > 0.95, f"sign accuracy {out['sign_accuracy']}")
    print("deep_kernel_learning: OK")
    return out


if __name__ == "__main__":
    run_cli(main, __doc__)

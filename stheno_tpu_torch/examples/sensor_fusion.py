"""Sensor fusion (`examples/sensor_fusion.py`, BASELINE #3) on the port: one
latent process observed through two sensors with different structured
noise; conditioning on both recovers the latent.

    f      ~ GP(v·SE(·/l))                       the latent signal
    noise1 = s1·GP(White) + (sin(x) − 5 + √|x|)  sensor 1's noise
    noise2 = s2·GP(3.5, White)                   sensor 2's noise (bias 3.5)
    y1 = f + noise1 ; y2 = f + noise2            what the sensors read

`model()` is the example's programme (v = l = 1, s1 = √0.01, s2 = √0.1);
`model(v, l, s1, s2)` takes hyperparameters, tensors or numbers, for the
full-width run of `chip_smoke.py` (`full_data`, `nlml`, `predict`).

    python -m stheno_tpu_torch.examples.sensor_fusion [--device cpu]

The observations are a prior draw from a CPU `torch.Generator` seeded 123456,
the reference's key number; the inputs come from numpy's
`default_rng(123456)`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stheno_tpu_torch import BlockData, GPPPInput, logpdf, marginals, posterior, rand, split
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.examples._common import check, numpy, run_cli, tensor
from stheno_tpu_torch.gppp import gppp
from stheno_tpu_torch.graph import GP
from stheno_tpu_torch.kernels import SEKernel, WhiteKernel, with_lengthscale

#: the example's hyperparameters
THETA = dict(v=1.0, l=1.0, s1=math.sqrt(1e-2), s2=math.sqrt(1e-1))
BIAS2 = 3.5


def noise1_mean(x):
    return torch.sin(x) - 5.0 + torch.sqrt(torch.abs(x))


@gppp
def model(v=THETA["v"], l=THETA["l"], s1=THETA["s1"], s2=THETA["s2"]):  # noqa: E741
    f = GP(v * with_lengthscale(SEKernel(), l))
    noise1 = s1 * GP(WhiteKernel()) + noise1_mean
    noise2 = s2 * GP(BIAS2, WhiteKernel())
    return dict(f=f, noise1=noise1, noise2=noise2, y1=f + noise1, y2=f + noise2)


#: the observations' noise of the full-width run, and of its query
FULL_NOISE = 1e-6


def data(dev, n1=3, n2=10):
    """y1 at `n1` and y2 at `n2` sorted uniform points of [0, 10], jointly
    as `BlockData` (the example's 3 and 10)."""
    rng = np.random.default_rng(123456)
    x1 = tensor(np.sort(rng.uniform(0, 10, n1)), dev)
    x2 = tensor(np.sort(rng.uniform(0, 10, n2)), dev)
    return BlockData(GPPPInput("y1", x1), GPPPInput("y2", x2))


def query(xp):
    """f, y1 and y2 jointly at `xp`."""
    return BlockData(GPPPInput("f", xp), GPPPInput("y1", xp), GPPPInput("y2", xp))


def main(device="cuda", fast=False):
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(123456)
    f = model()
    x = data(dev)
    yhat = rand(gen, f(x, 1e-12))
    y1hat, y2hat = split(x, yhat)
    out = {"sensor2_mean": y2hat.mean().item(), "bias2": math.sqrt(0.1) * BIAS2}
    print(f"sensor1 obs: {np.round(numpy(y1hat), 2)}")
    print(f"sensor2 obs mean: {out['sensor2_mean']:.2f} (bias sqrt(0.1)*3.5 = {out['bias2']:.2f})")

    post = posterior(f(x, 1e-12), yhat)
    xp = torch.linspace(-2.5, 12.5, 500, dtype=torch.float64, device=dev)
    xp_all = query(xp)
    ms = marginals(post(xp_all, 1e-9))
    mf, m1, m2 = split(xp_all, ms.mean)
    vf, _, _ = split(xp_all, ms.var)

    # the sensors' posterior means differ from the latent's by their noise
    # means: y1 − f ≈ sin(x) − 5 + √|x|; y2 − f ≈ √0.1·3.5 (the scaling
    # multiplies the mean too, as in the reference's model)
    out["err1"] = ((m1 - mf) - noise1_mean(xp)).abs().max().item()
    out["err2"] = ((m2 - mf) - out["bias2"]).abs().max().item()
    print(f"|E[y1-f] - noise1_mean|_inf = {out['err1']:.2e}")
    print(f"|E[y2-f] - {out['bias2']:.3f}|_inf        = {out['err2']:.2e}")
    check(out["err1"] < 1e-6 and out["err2"] < 1e-6,
          f"the sensors' noise means: {out['err1']}, {out['err2']}")

    # the latent variance collapses near the observations, grows away
    var_at_obs = np.interp(numpy(x.blocks[1].x), numpy(xp), numpy(vf))
    out["var_near"], out["var_far"] = float(np.max(var_at_obs)), vf[0].item()
    check(out["var_far"] > out["var_near"],
          f"latent variance far from the data {out['var_far']} <= near it {out['var_near']}")
    print(f"latent var near data: {out['var_near']:.3f}; far from data: {out['var_far']:.3f}")

    ys = rand(gen, post(xp_all, 1e-9), 7)
    check(bool(torch.isfinite(ys).all()), "the joint posterior samples are not finite")
    print("sensor_fusion: OK")
    return out


# --- the full-width run -------------------------------------------------------


def full_data(n_per=8192, dtype=torch.float32, device="cuda"):
    """`(x, y)`: y1 and y2 each on a grid of `n_per` points of [0, 10] (y2's
    offset by half a step), as `BlockData` in `dtype`, and a draw of the
    example's programme at those inputs (in f64 on `device`, from a CPU
    generator seeded 123456, then cast to `dtype`).  Grids, not uniform
    draws: at this N, uniform draws rounded to f32 put some points of one
    sensor on the same input, where `WhiteKernel` (1 where the inputs are
    equal) makes them one noise variable, the covariance singular to its
    jitter and the draw inconsistent with it."""
    dev = resolve_device(device)
    step = 10.0 / n_per
    x1 = torch.linspace(0.0, 10.0 - step, n_per, dtype=dtype, device=dev)
    x = BlockData(GPPPInput("y1", x1), GPPPInput("y2", x1 + step / 2))
    x64 = BlockData(*(GPPPInput(b.p, b.x.to(torch.float64)) for b in x.blocks))
    with torch.no_grad():
        y = rand(torch.Generator().manual_seed(123456), model()(x64, FULL_NOISE))
    return x, y.to(dtype)


def nlml(theta, x, y):
    """−logpdf of the sensors' readings `y` at `x` under `model(**theta)`."""
    return -logpdf(model(**theta)(x, FULL_NOISE), y)


def predict(theta, x, y, xp):
    """The joint posterior marginals of f, y1 and y2 at `xp`."""
    with torch.no_grad():
        post = posterior(model(**theta)(x, FULL_NOISE), y)
        return marginals(post(query(xp), FULL_NOISE))


if __name__ == "__main__":
    run_cli(main, __doc__)

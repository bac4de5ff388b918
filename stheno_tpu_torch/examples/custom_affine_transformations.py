"""Custom affine transformations (`examples/custom_affine_transformations.py`)
on the port: the extension contract.  A user-defined process class takes
full part in a programme once it supplies

- the statistics `mean/cov/cov2/var/var2`, and
- the cross rules `_cross_cov_l/_r` and `_cross_var_l/_r` (the process on
  the left or on the right of a cross-covariance with any other process),

in terms of its parent's; sums, scalings, GPPP routing, posteriors and
VFE then compose with it.  Here (Af)(x) = f(x) + f(x + 3) − 2, checked by
`utils.testing.check_process_interface` as the reference checks it.

    python -m stheno_tpu_torch.examples.custom_affine_transformations [--device cpu]

The observations are a prior draw from a CPU `torch.Generator` seeded 0, the
reference's key number; the inputs come from numpy's `default_rng(0)`.
"""

from __future__ import annotations

import numpy as np
import torch

from stheno_tpu_torch import BlockData, GPPPInput, logpdf, posterior, rand
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.examples._common import check, run_cli, tensor
from stheno_tpu_torch.gppp import gppp
from stheno_tpu_torch.graph import GP, GPC, AbstractProcess, cross_cov, cross_var
from stheno_tpu_torch.kernels import SEKernel
from stheno_tpu_torch.tree import frozen_dataclass, static_field
from stheno_tpu_torch.utils.testing import check_process_interface


@frozen_dataclass(eq=False)
class AGP(AbstractProcess):
    """(Af)(x) = f(x) + f(x + 3) − 2."""

    f: AbstractProcess
    n: int = static_field()
    gpc: GPC = static_field()

    def _s(self, x):
        return x + 3.0

    def mean(self, x):
        return self.f.mean(x) + self.f.mean(self._s(x)) - 2.0

    def cov(self, x):
        return self.cov2(x, x)

    def cov2(self, x, x2):
        f, s = self.f, self._s
        return f.cov2(x, x2) + f.cov2(x, s(x2)) + f.cov2(s(x), x2) + f.cov2(s(x), s(x2))

    def var(self, x):
        return self.var2(x, x)

    def var2(self, x, x2):
        f, s = self.f, self._s
        return f.var2(x, x2) + f.var2(x, s(x2)) + f.var2(s(x), x2) + f.var2(s(x), s(x2))

    def _cross_cov_l(self, g, x, x2):
        return cross_cov(self.f, g, x, x2) + cross_cov(self.f, g, self._s(x), x2)

    def _cross_cov_r(self, g, x, x2):
        return cross_cov(g, self.f, x, x2) + cross_cov(g, self.f, x, self._s(x2))

    def _cross_var_l(self, g, x, x2):
        return cross_var(self.f, g, x, x2) + cross_var(self.f, g, self._s(x), x2)

    def _cross_var_r(self, g, x, x2):
        return cross_var(g, self.f, x, x2) + cross_var(g, self.f, x, self._s(x2))


def A(f: AbstractProcess) -> AGP:
    return AGP(f, n=f.gpc.next_index(), gpc=f.gpc)


@gppp
def model():
    f = GP(SEKernel())
    return dict(f=f, Af=A(f))


def main(device="cuda", fast=False):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    g = model()
    f, Af = g["f"], g["Af"]
    x = tensor(rng.normal(size=5), dev)
    x2 = tensor(rng.normal(size=7), dev)

    # the defining identities against their oracles
    out = {"mean_err": (Af.mean(x) - (f.mean(x) + f.mean(x + 3) - 2.0)).abs().max().item(),
           "cross_err": (cross_cov(Af, f, x, x2) - (f.cov2(x, x2) + f.cov2(x + 3, x2)))
           .abs().max().item()}
    check(out["mean_err"] < 1e-12 and out["cross_err"] < 1e-12, f"the defining identities {out}")
    # the interface conformance the reference runs (script.jl:158-164)
    check_process_interface(Af, x, tensor(rng.normal(size=5), dev), x2, f2=f)
    check_process_interface(
        g, GPPPInput("Af", x), GPPPInput("Af", tensor(rng.normal(size=5), dev)),
        BlockData(GPPPInput("f", x2), GPPPInput("Af", x)))

    # the custom node composes: condition on Af, read off f
    xo = tensor(np.sort(rng.uniform(-3, 3, 20)), dev)
    fx = g(GPPPInput("Af", xo), 0.1)
    y = rand(gen, fx)
    out["logpdf"] = logpdf(fx, y).item()
    post = posterior(fx, y)
    m_f, v_f = post.mean(GPPPInput("f", xo)), post.var(GPPPInput("f", xo))
    check(bool(torch.isfinite(m_f).all()), "the posterior mean of f is not finite")
    check(bool((v_f > 0).all()), "the posterior variance of f is not positive")
    # and so do composites of the custom node
    h = 2.0 * Af + f
    check_process_interface(h, x, tensor(rng.normal(size=5), dev), f2=Af)
    print(f"logpdf under custom op: {out['logpdf']:.3f}")
    print("custom_affine_transformations: OK")
    return out


if __name__ == "__main__":
    run_cli(main, __doc__)

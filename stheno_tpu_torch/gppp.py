"""GPPP — the Gaussian-process probabilistic programme (counterpart of
`stheno_tpu/gppp.py`).

A `GPPP` is a named collection of processes of one programme, treated as a
single GP over tagged inputs.  The `@gppp` decorator turns a builder, a
plain function from hyperparameters to a dict of processes, into one:

    @gppp
    def model(theta):
        f1 = GP(theta["v"] * SEKernel())
        f2 = GP(Matern32Kernel())
        return dict(f1=f1, f2=f2, f3=f1 + f2)

    fx = model(theta)(GPPPInput("f3", x), 0.1)

A query is a `GPPPInput` (one process at some inputs), a `BlockData` of
them (several processes jointly: the blocks are stacked by `graph.cross`,
so `cov2` across two different `BlockData` runs through `cross_cov`), or a
list of `(name, point)` pairs, grouped by name in order of first appearance
into a `BlockData`:

    fx = model(theta)(BlockData(GPPPInput("f1", x1), GPPPInput("f3", x3)), noise)
"""

from __future__ import annotations

import functools

import torch

from stheno_tpu_torch.graph import GPC, AbstractProcess, cross, cross_cov, cross_var
from stheno_tpu_torch.inputs import BlockData, GPPPInput
from stheno_tpu_torch.tree import frozen_dataclass, static_field


@frozen_dataclass(eq=False)
class GPPP:
    """Named collection of processes interpreted as one GP over tagged inputs."""

    processes: dict
    gpc: GPC = static_field()

    def extract(self, x):
        """Map tagged inputs to (process node, raw inputs)."""
        if isinstance(x, GPPPInput):
            if x.p not in self.processes:
                raise KeyError(f"GPPP has no process {x.p!r}; has {sorted(self.processes)}")
            return self.processes[x.p], x.x
        if isinstance(x, BlockData):
            pairs = [self.extract(b) for b in x.blocks]
            return cross([p for p, _ in pairs]), BlockData(*[v for _, v in pairs])
        if isinstance(x, (list, tuple)) and x and isinstance(x[0], tuple):
            grouped = {}  # name → points, in order of first appearance
            for p, v in x:
                grouped.setdefault(p, []).append(v)
            blocks = [GPPPInput(p, torch.stack([torch.as_tensor(v) for v in vs]))
                      for p, vs in grouped.items()]
            return self.extract(BlockData(*blocks))
        raise TypeError(
            f"GPPP inputs must be GPPPInput, BlockData, or [(name, x), ...]; got {type(x)}"
        )

    def mean(self, x):
        f, v = self.extract(x)
        return f.mean(v)

    def cov(self, x):
        f, v = self.extract(x)
        return f.cov(v)

    def cov2(self, x, x2):
        f, v = self.extract(x)
        f2, v2 = self.extract(x2)
        return cross_cov(f, f2, v, v2)

    def var(self, x):
        f, v = self.extract(x)
        return f.var(v)

    def var2(self, x, x2):
        f, v = self.extract(x)
        f2, v2 = self.extract(x2)
        return cross_var(f, f2, v, v2)

    def mean_and_cov(self, x):
        f, v = self.extract(x)
        return f.mean(v), f.cov(v)

    def mean_and_var(self, x):
        f, v = self.extract(x)
        return f.mean(v), f.var(v)

    def __getitem__(self, name) -> AbstractProcess:
        return self.processes[name]

    def __contains__(self, name):
        return name in self.processes

    def _validate_tags(self, x):
        """Check tags eagerly so `f(x, noise)` fails at the user's mistake."""
        if isinstance(x, GPPPInput):
            if x.p not in self.processes:
                raise KeyError(f"GPPP has no process {x.p!r}; has {sorted(self.processes)}")
        elif isinstance(x, BlockData):
            for b in x.blocks:
                self._validate_tags(b)
        elif isinstance(x, (list, tuple)) and x and isinstance(x[0], tuple):
            for p, _ in x:
                self._validate_tags(GPPPInput(p, None))

    def __call__(self, x, noise=None):
        from stheno_tpu_torch.finite_gp import FiniteGP

        self._validate_tags(x)
        return FiniteGP(self, x, noise)


def gppp(fn=None):
    """Decorator: run the builder inside a fresh `GPC` context and wrap the
    returned ``dict[str, process]`` into a `GPPP`."""

    def wrap(f):
        @functools.wraps(f)
        def build(*args, **kwargs):
            with GPC() as gpc:
                out = f(*args, **kwargs)
            if isinstance(out, GPPP):
                return out
            if not isinstance(out, dict):
                raise TypeError("@gppp builder must return a dict of named processes")
            for k, v in out.items():
                if not isinstance(v, AbstractProcess):
                    raise TypeError(f"process {k!r} is not an AbstractProcess")
            return GPPP(dict(out), gpc)

        return build

    if fn is None:
        return wrap
    return wrap(fn)

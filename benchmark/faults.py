"""Faults planted underneath the timed path, for the control readings
(`controls.py`) and the tests: each patches the port (`stheno_tpu_torch`),
or the optimizer its fit uses, for the extent of a `with` block, and the
harness runs as it always does.

- `unchanged_state`: every Adam step returns θ and its state unchanged;
- `half_batch`: half of the observations left out (every other point), the
  fit's objective scaled by 2 as a mean over the rest would be, a request
  conditioned on the halved data;
- `altered_answer`: the first posterior mean of every request moved by
  `SHIFT`.

A fault is found by name beside the cell's programme (`plant`): where the
adapter `programmes/<programme>.py` defines a function of the fault's name,
that function is planted, and otherwise the shared one here.  Which port
calls carry a programme's observations only its adapter knows, so
`half_batch` has no shared version.  The rule stays here: an adapter's own
fault names the port functions to wrap and which of their arguments are
observations, through `halving` (with `objective` and `request`) or
`altering`, and states no rule of its own.  It wraps the port's functions,
never the adapter's own: each run loads a copy of the adapter of its own.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
from pathlib import Path
from typing import NamedTuple
from unittest import mock

import torch
from harness.registry import BENCH_DIR, Registry

SHIFT = 0.05
#: The faults each kind of traffic can have.
BY_KIND = {"fit": ("unchanged_state", "half_batch"),
           "query": ("half_batch", "altered_answer"),
           "predict": ("half_batch", "altered_answer")}


def programme_of(root, cell):
    """The adapter module of `cell`'s configuration, as the harness loads it."""
    reg = Registry(root)
    return reg.programme(reg.config(reg.cell(cell)["config"])["programme"])


@contextlib.contextmanager
def unchanged_state():
    with mock.patch.object(torch.optim.Adam, "step", lambda self, closure=None: None):
        yield


def halve(value):
    """`half_batch`'s rule for one observed argument: every other point of
    a tensor, of the inputs a `GPPPInput` tags, of each block of a
    `BlockData`, of each item of a tuple or list, and of a `FiniteGP`'s
    inputs with their noise."""
    from stheno_tpu_torch import finite_gp
    from stheno_tpu_torch.inputs import BlockData, GPPPInput

    if torch.is_tensor(value):
        return value[::2].contiguous()
    if isinstance(value, GPPPInput):
        return GPPPInput(value.p, halve(value.x))
    if isinstance(value, BlockData):
        return BlockData(*(halve(b) for b in value.blocks))
    if isinstance(value, (tuple, list)):
        return type(value)(halve(v) for v in value)
    if isinstance(value, finite_gp.FiniteGP):
        return finite_gp.FiniteGP(value.f, halve(value.x), _halve_noise(value.noise, value.x))
    raise TypeError(f"half_batch has no rule for an observation of type {type(value).__name__}")


def _kept(x):
    """The indices `halve` keeps of the points of inputs `x`."""
    from stheno_tpu_torch.inputs import BlockData, input_length

    if not isinstance(x, BlockData):
        return torch.arange(0, input_length(x), 2)
    starts = torch.tensor((0, *x.block_sizes)).cumsum(0).tolist()
    return torch.cat([torch.arange(a, b, 2) for a, b in zip(starts, starts[1:])])


def _halve_noise(noise, x):
    """A `FiniteGP`'s noise at the points `halve` keeps: a shared variance
    as it is, a variance a point at those points."""
    from stheno_tpu_torch import finite_gp

    if not isinstance(noise, finite_gp.DiagNoise):
        raise TypeError(f"half_batch has no rule for noise of type {type(noise).__name__}")
    if noise.d.dim() == 0:
        return noise
    return finite_gp.DiagNoise(noise.d[_kept(x).to(noise.d.device)])


class Halved(NamedTuple):
    """Where a port function takes observations, and what its result is:
    each of `observed` a parameter's name, or a name and the indices into
    it (`("data", 0)`: the first item of the argument `data`); `scale` 2
    for a fit's objective, 1 for a request."""

    observed: tuple
    scale: float


def objective(*observed):
    """A fit's objective over `observed`: halved, its value scaled by 2."""
    return Halved(observed, 2.0)


def request(*observed):
    """A request conditioned on `observed`: halved, its answer as it is."""
    return Halved(observed, 1.0)


def _at(value, path):
    """`value` with `halve` applied at the indices `path` inside it."""
    if not path:
        return halve(value)
    items = list(value)
    items[path[0]] = _at(items[path[0]], path[1:])
    return type(value)(items)


@contextlib.contextmanager
def _wrapping(targets):
    """Each `(owner, name, wrap)` of `targets`: the owner's function of
    that name replaced by `wrap` of it."""
    with contextlib.ExitStack() as stack:
        for owner, name, wrap in targets:
            stack.enter_context(mock.patch.object(owner, name, wrap(getattr(owner, name))))
        yield


def _halved(fn, how):
    sig = inspect.signature(fn)
    observed = [(o,) if isinstance(o, str) else tuple(o) for o in how.observed]
    for name, *_ in observed:
        if name not in sig.parameters:
            raise TypeError(f"{fn.__qualname__} takes no argument {name!r}")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        for name, *path in observed:
            bound.arguments[name] = _at(bound.arguments[name], path)
        out = fn(*bound.args, **bound.kwargs)
        return out if how.scale == 1.0 else how.scale * out

    return wrapped


def halving(targets):
    """`half_batch` over `targets`, `{owner: {name: objective(...) or
    request(...)}}`: each owner a module or class of the port, each name one
    of its functions through which a programme's observations pass."""
    return _wrapping((owner, name, functools.partial(_halved, how=how))
                     for owner, names in targets.items() for name, how in names.items())


def _shifted(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        m = fn(*args, **kwargs).clone()
        m[0] += SHIFT
        return m

    return wrapped


def altering(targets):
    """`altered_answer` over `targets`, `{owner: (name, ...)}`: each named
    function of the port returns posterior means, and the first moves by
    `SHIFT`."""
    return _wrapping((owner, name, _shifted) for owner, names in targets.items() for name in names)


def altered_answer():
    from stheno_tpu_torch import finite_gp

    return altering({finite_gp.PosteriorGP: ("mean",)})


#: The faults every programme shares, unless its adapter defines its own.
SHARED = {"unchanged_state": unchanged_state, "altered_answer": altered_answer}
FAULTS = sorted({f for kind in BY_KIND.values() for f in kind})


def plant(name, programme):
    """The fault `name` for a cell whose adapter is the module `programme`
    (`programme_of(root, cell)`): the adapter's own function of that name
    where it has one, the shared one otherwise."""
    if name not in FAULTS:
        raise KeyError(f"unknown fault {name!r}; the faults are {FAULTS}")
    own = getattr(programme, name, None)
    if own is not None:
        return own()
    if name in SHARED:
        return SHARED[name]()
    path = f"{BENCH_DIR}/programmes/{Path(programme.__file__).stem}.py"
    raise NotImplementedError(
        f"{path} defines no {name}: write `def {name}():` there, returning "
        "`faults.halving({owner: {function: faults.objective(...) or faults.request(...)}})` "
        "(`import faults` inside the function), naming every port function through which the "
        "programme's observations pass (its fit's objective, the posterior it holds, a request's "
        "own data) and the arguments that hold them, so that each sees every other point")

"""Constrained parameters (counterpart of `stheno_tpu/params.py`): the
ParameterHandling.jl idiom on tensors.

A spec is a tree (dicts, lists, tuples) whose leaves are `Param`s (a raw,
unconstrained tensor and a bijector), `Fixed` values (left out of the
optimisation) or plain values (unconstrained):

    spec = dict(
        var=positive(1.0),
        ell=positive(0.5, lb=1e-3),
        w=bounded(0.3, 0.0, 1.0),
        z=fixed(torch.linspace(0, 1, 8)),
    )
    theta0, unflatten = init(spec)   # flat unconstrained vector
    params = unflatten(theta0)       # dict of constrained values

A frozen dataclass inside a spec (a `LinearLayer` of the NKN, say) is a
node whose fields that are not `static_field`s are its children, as a JAX
pytree dataclass is; its raw tensors are free leaves (the NKN's log-weights
train unconstrained beside constrained hyperparameters).

The flat vector follows `jax.flatten_util.ravel_pytree`'s leaf order (dict
keys sorted, dataclass fields in declaration order, `Fixed` leaves left
out), so one spec gives the same θ here and in the reference.  A leaf
keeps the dtype and device of the tensor it was made from; a Python number
becomes float64, as the reference's `dtype=float` does under x64.  Bounds given as numbers stay numbers.
"""

from __future__ import annotations

import dataclasses

import torch

from stheno_tpu_torch.tree import as_param, frozen_dataclass, static_field


@frozen_dataclass
class Param:
    """A value with a constraint bijector: `raw` is the unconstrained
    representation, `transform`/`inverse` map raw ↔ constrained."""

    raw: torch.Tensor
    transform: object = static_field()
    inverse: object = static_field()

    @property
    def value(self):
        return self.transform(self.raw)


@frozen_dataclass
class Fixed:
    """A value left out of the flat optimisation vector."""

    value: object


def _as_float(v):
    """`v` as a floating tensor: a floating tensor as it is, anything else
    as float64."""
    if torch.is_tensor(v) and v.is_floating_point():
        return v
    return torch.as_tensor(v, dtype=torch.float64)


def _softplus(r):
    # log(1 + eʳ) without a threshold, as jax.nn.softplus computes it
    return torch.logaddexp(r, torch.zeros_like(r))


def _softplus_inv(v):
    # log(eᵛ − 1), stable for large v
    return v + torch.log(-torch.expm1(-v))


def exp_transform(lb=0.0):
    """(transform, inverse) of `positive`: value = exp(raw) + lb."""
    return (lambda r: torch.exp(r) + lb), (lambda v: torch.log(v - lb))


def softplus_transform(lb=0.0):
    """(transform, inverse) of `softplus_positive`: softplus(raw) + lb."""
    return (lambda r: _softplus(r) + lb), (lambda v: _softplus_inv(v - lb))


def logistic_transform(lo, hi):
    """(transform, inverse) of `bounded`: lo + (hi − lo)·sigmoid(raw)."""

    def inverse(v):
        u = (v - lo) / (hi - lo)
        return torch.log(u) - torch.log1p(-u)

    return (lambda r: lo + (hi - lo) * torch.sigmoid(r)), inverse


#: The bijectors by the name of the constructor that makes them.
TRANSFORMS = {
    "positive": exp_transform,
    "softplus_positive": softplus_transform,
    "bounded": logistic_transform,
}


def _param(init, transform, inverse):
    return Param(inverse(_as_float(init)), transform, inverse)


def positive(init, lb=0.0):
    """A strictly positive parameter: value = exp(raw) + lb."""
    return _param(init, *exp_transform(lb))


def softplus_positive(init, lb=0.0):
    """A positive parameter through softplus: flatter tails than exp."""
    return _param(init, *softplus_transform(lb))


def bounded(init, lo, hi):
    """A parameter in (lo, hi) through a scaled logistic."""
    return _param(init, *logistic_transform(lo, hi))


def fixed(value):
    return Fixed(as_param(value))


def _children(node):
    """The child fields of a dataclass node: those not marked static."""
    return [f.name for f in dataclasses.fields(node) if not f.metadata.get("static")]


def _is_node(spec):
    return dataclasses.is_dataclass(spec) and not isinstance(spec, (type, Param, Fixed))


def _map_node(fn, node):
    return dataclasses.replace(node, **{k: fn(getattr(node, k)) for k in _children(node)})


def constrain(spec):
    """The spec with each `Param` and `Fixed` replaced by its value."""
    if isinstance(spec, (Param, Fixed)):
        return spec.value
    if isinstance(spec, dict):
        return {k: constrain(v) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return type(spec)(constrain(v) for v in spec)
    if _is_node(spec):
        return _map_node(constrain, spec)
    return spec


def _free_leaves(spec, out):
    """Append the spec's free leaves (raw values and plain values) to `out`
    in `ravel_pytree`'s order: dict keys sorted, `Fixed` and None left out."""
    if spec is None or isinstance(spec, Fixed):
        return
    if isinstance(spec, Param):
        out.append(spec.raw)
    elif isinstance(spec, dict):
        for k in sorted(spec):
            _free_leaves(spec[k], out)
    elif isinstance(spec, (list, tuple)):
        for v in spec:
            _free_leaves(v, out)
    elif _is_node(spec):
        for k in _children(spec):
            _free_leaves(getattr(spec, k), out)
    else:
        out.append(_as_float(spec))


def init(spec):
    """`(theta0, unflatten)`: `theta0` is the flat unconstrained vector of
    the spec's free leaves, and `unflatten(theta)` maps a flat vector back
    to the tree of constrained values (Fixed values in place).  `unflatten`
    is differentiable in `theta`."""
    leaves = []
    _free_leaves(spec, leaves)
    theta0 = torch.cat([t.detach().reshape(-1) for t in leaves])
    shapes = [(t.shape, t.dtype) for t in leaves]
    sizes = [t.numel() for t in leaves]

    def unflatten(theta):
        pieces = iter(p.reshape(shape).to(dtype) for p, (shape, dtype)
                      in zip(torch.split(theta, sizes), shapes))

        def merge(s):
            if s is None or isinstance(s, Fixed):
                return None if s is None else s.value
            if isinstance(s, Param):
                return s.transform(next(pieces))
            if isinstance(s, dict):
                vals = {k: merge(s[k]) for k in sorted(s)}
                return {k: vals[k] for k in s}
            if isinstance(s, (list, tuple)):
                return type(s)(merge(v) for v in s)
            if _is_node(s):
                return _map_node(merge, s)
            return next(pieces)

        return merge(spec)

    return theta0, unflatten

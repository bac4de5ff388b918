"""Frozen-dataclass helper (counterpart of `stheno_tpu/tree.py`), and the
flattening of trees of tensors that the samplers and checkpoints need.

Every structural object of the port (kernels, means, process-graph nodes,
inputs, finite GPs, posteriors) is an immutable frozen dataclass holding
tensors.  PyTorch has no pytrees to register: tensors are differentiated by
autograd wherever they sit, so `static_field` only documents which fields
are structural metadata (process ids, tags, callables) rather than numbers.
Sampler positions and states are plain trees (NamedTuples, dicts, lists,
tuples of tensors), flattened in the reference's order by
`tree_leaves_with_path` and `ravel_pytree`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field

import numpy as np
import torch


def static_field(**kwargs):
    """A dataclass field holding structural metadata, not a tensor."""
    metadata = dict(kwargs.pop("metadata", {}))
    metadata["static"] = True
    return field(metadata=metadata, **kwargs)


def as_param(v):
    """A hyperparameter as the dataclasses hold it: a tensor as given (so
    autograd reaches it), a Python number as a float (so it takes the dtype
    of the tensors it meets, as a weakly typed JAX scalar does), anything
    else (a list, a numpy array) as a tensor of its own dtype."""
    if torch.is_tensor(v):
        return v
    if isinstance(v, (int, float)):
        return float(v)
    return torch.as_tensor(np.asarray(v))


def frozen_dataclass(cls=None, **kwargs):
    """Decorator: `dataclasses.dataclass(frozen=True)`."""

    def wrap(c):
        return dataclasses.dataclass(frozen=True, **kwargs)(c)

    if cls is None:
        return wrap
    return wrap(cls)


def tree_leaves_with_path(tree, path=""):
    """`[(path, leaf), ...]` of a tree of NamedTuples, dicts, lists and
    tuples, in the order and with the path strings of the reference's
    `jax.tree_util.tree_flatten_with_path` (as `inference/checkpoint.py`
    writes them): a NamedTuple field is `.name`, a dict entry `['key']`
    (keys sorted), a list or tuple item `[i]`; None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{name}", getattr(tree, name)) for name in tree._fields]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(path, tree)]
    out = []
    for p, v in items:
        out.extend(tree_leaves_with_path(v, path + p))
    return out


def tree_unflatten(like, leaves):
    """A tree of `like`'s structure holding `leaves` (in the order of
    `tree_leaves_with_path(like)`)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, name)) for name in t._fields))
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def ravel_pytree(tree, batch_ndim=0):
    """`(flat, unravel)`: the tree's tensor leaves concatenated into one
    vector in `tree_leaves_with_path` order (dict keys sorted, as
    `jax.flatten_util.ravel_pytree`), in their promoted dtype, after
    `batch_ndim` leading dimensions that every leaf shares.  `unravel(v)`
    maps a vector, or any stack of them (..., d), back to the tree, each
    leaf in its own dtype with the stack's leading dimensions in front."""
    leaves = [torch.as_tensor(leaf) for _, leaf in tree_leaves_with_path(tree)]
    if not leaves:
        raise ValueError("ravel_pytree: the tree holds no tensor")
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    lead = leaves[0].shape[:batch_ndim]
    shapes = [leaf.shape[batch_ndim:] for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
    flat = torch.cat([leaf.reshape((*lead, -1)).to(dtype) for leaf in leaves], dim=-1)

    def unravel(v):
        front = v.shape[:-1]
        parts = torch.split(v, sizes, dim=-1)
        return tree_unflatten(tree, [p.reshape((*front, *s)).to(dt)
                                     for p, s, dt in zip(parts, shapes, dtypes)])

    return flat, unravel

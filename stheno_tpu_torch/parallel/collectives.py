"""Differentiable collectives with `shard_map`'s gradient rules: the port's
stand-ins for `lax.psum`, `lax.all_gather`, `lax.ppermute`,
`lax.all_to_all` and `lax.axis_index` (no counterpart module in the
reference).

Every rank runs the whole program (see the package docstring).  A tensor
is either *varying* (each rank holds its own value: a row slab) or
*invariant* (every rank holds the same value: a hyperparameter, a gathered
panel, a reduced scalar).  The loss every rank back-propagates is
invariant, and the rules below keep one invariant true through the
backward pass: the cotangent of an invariant tensor is, on every rank, the
whole gradient; the cotangent of a varying tensor is that rank's piece.

- `psum` (varying → invariant): all-reduce; backward the identity.
- `all_gather` (varying → invariant, rows concatenated in rank order):
  backward takes the rank's own rows.
- `pvary` (invariant → varying): the identity; backward all-reduces the
  cotangent.  It goes wherever an invariant tensor enters rank-local work
  (hyperparameters, a diagonal factor, a gathered panel used for the
  rank's own rows), so the ranks' local contributions are summed once.
  `pvary_tree` applies it to every tensor leaf of a kernel, a process
  graph or a `FiniteGP`; `shard` is `pvary` followed by the rank's slice.
- `ppermute` (varying → varying): a shift around the ring by
  `batch_isend_irecv`; backward the inverse shift.
- `all_to_all` (varying → varying): block d of the leading axis goes to
  rank d; backward the same exchange of the cotangent.
- `broadcast` (→ invariant, bit for bit): the axis's rank `src`'s tensor
  on every rank; not differentiable.

`torch.distributed.nn.functional.all_reduce` is not used: its backward
all-reduces the cotangent of the replicated loss, so every rank's gradient
comes out summed over the ranks (P times too large in total).

Every rank must build the same autograd graph, so that the backward's
collectives run in the same order everywhere: rank-dependent choices are
data (a mask, a slice offset), never a Python branch around a collective
or around what requires a gradient.

Each collective counts its communication calls in `COUNTERS` (by shape),
as the kernel wrappers count launches, where it communicates: `psum` and
`all_gather` in the forward pass, `pvary` in the backward, `ppermute` and
`all_to_all` in both, `broadcast` over more than one rank.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from stheno_tpu_torch.cuda._build import LaunchCounter
from stheno_tpu_torch.inputs import BlockData

#: Each collective's communication calls, by name.
COUNTERS = {name: LaunchCounter(name)
            for name in ("psum", "all_gather", "pvary", "ppermute", "all_to_all", "broadcast")}


def reset_counters() -> None:
    for counter in COUNTERS.values():
        counter.reset()


def total_calls() -> int:
    return sum(c.total for c in COUNTERS.values())


class Axis:
    """One named axis of a mesh: its process group, size and this rank's
    index along it (`lax.axis_size` and `lax.axis_index`)."""

    def __init__(self, mesh, axis_name):
        if axis_name not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh has no axis {axis_name!r}; has {mesh.mesh_dim_names}")
        self.mesh, self.name = mesh, axis_name
        self.group = mesh.get_group(axis_name)
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def rows(self, n):
        """The global rows [a, b) of this rank's slab of n rows."""
        if n % self.size != 0:
            raise ValueError(f"N={n} must divide evenly over {self.size} ranks (pad first)")
        n_loc = n // self.size
        return self.rank * n_loc, (self.rank + 1) * n_loc


def axis_index(mesh, axis_name="rows") -> int:
    """`lax.axis_index`: this rank's index along the axis."""
    return Axis(mesh, axis_name).rank


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        p, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.rows = (rank * x.shape[0], (rank + 1) * x.shape[0])
        x = x.contiguous()
        if dist.get_backend(group) == "nccl":
            out = x.new_empty((p * x.shape[0], *x.shape[1:]))
            dist.all_gather_into_tensor(out, x, group=group)
            return out
        parts = [torch.empty_like(x) for _ in range(p)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.rows
        return g[a:b], None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        COUNTERS["pvary"].add(tuple(out.shape))
        dist.all_reduce(out, group=ctx.group)
        return out, None


def _shift(x, group, shift):
    """Send x to the rank `shift` ahead and receive the one from `shift`
    behind, in one `batch_isend_irecv`."""
    p, rank = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    dst = dist.get_global_rank(group, (rank + shift) % p)
    src = dist.get_global_rank(group, (rank - shift) % p)
    COUNTERS["ppermute"].add(tuple(x.shape))
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for req in reqs:
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def _exchange(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    COUNTERS["all_to_all"].add(tuple(x.shape))
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def psum(x, ax: Axis):
    """Σ over the axis of a varying tensor: invariant."""
    COUNTERS["psum"].add(tuple(x.shape))
    return _PSum.apply(x, ax.group)


def all_gather(x, ax: Axis):
    """The ranks' varying (n, ...) tensors concatenated in rank order: an
    invariant (P·n, ...) tensor (`lax.all_gather(..., tiled=True)`)."""
    COUNTERS["all_gather"].add(tuple(x.shape))
    return _AllGather.apply(x, ax.group)


def pvary(x, ax: Axis):
    """An invariant tensor entering rank-local work (a tensor that needs no
    gradient passes as it is)."""
    if not (torch.is_tensor(x) and x.requires_grad and torch.is_grad_enabled()):
        return x
    return _PVary.apply(x, ax.group)


def shard(x, ax: Axis):
    """The rank's slab of the leading axis of an invariant tensor."""
    a, b = ax.rows(x.shape[0])
    return pvary(x, ax)[a:b]


def ppermute(x, ax: Axis, shift=1):
    """Each rank's x to the rank `shift` ahead around the ring."""
    if ax.size == 1:
        return x
    return _PPermute.apply(x, ax.group, shift)


def all_to_all(x, ax: Axis):
    """x (P, ...): block d goes to rank d; returns (P, ...) with block s
    from rank s."""
    if x.shape[0] != ax.size:
        raise ValueError(f"all_to_all: leading axis {x.shape[0]} != axis size {ax.size}")
    return _AllToAll.apply(x, ax.group)


def broadcast(x, ax: Axis, src=0):
    """The tensor of the axis's rank `src` on every rank of the axis, bit
    for bit (a copy; `x` is left as it is)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if ax.size == 1:
        return out
    COUNTERS["broadcast"].add(tuple(out.shape))
    dist.broadcast(out, src=dist.get_global_rank(ax.group, src), group=ax.group)
    return out


def map_tensors(obj, fn, memo=None):
    """`obj` with `fn` applied to every tensor inside it: frozen dataclasses
    (kernels, means, process-graph nodes, inputs, noise, `FiniteGP`),
    dicts, lists and tuples are rebuilt around the new tensors; static
    fields and anything else are kept.  Each object is mapped once, so
    shared nodes stay shared."""
    memo = {} if memo is None else memo
    hit = memo.get(id(obj))
    if hit is not None:
        return hit[1]
    if torch.is_tensor(obj):
        out = fn(obj)
    elif isinstance(obj, BlockData):
        blocks = [map_tensors(b, fn, memo) for b in obj.blocks]
        out = obj if all(a is b for a, b in zip(blocks, obj.blocks)) else BlockData(*blocks)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {f.name: map_tensors(getattr(obj, f.name), fn, memo)
                   for f in dataclasses.fields(obj) if f.init and not f.metadata.get("static")}
        same = all(v is getattr(obj, k) for k, v in changes.items())
        out = obj if same else dataclasses.replace(obj, **changes)
    elif isinstance(obj, dict):
        vals = {k: map_tensors(v, fn, memo) for k, v in obj.items()}
        out = obj if all(vals[k] is obj[k] for k in obj) else type(obj)(vals)
    elif isinstance(obj, (list, tuple)):
        vals = [map_tensors(v, fn, memo) for v in obj]
        if all(a is b for a, b in zip(vals, obj)):
            out = obj
        elif hasattr(obj, "_fields"):
            out = type(obj)(*vals)
        else:
            out = type(obj)(vals)
    else:
        out = obj
    memo[id(obj)] = (obj, out)
    return out


def pvary_tree(obj, ax: Axis):
    """`pvary` on every tensor of `obj` that requires a gradient."""
    return map_tensors(obj, lambda t: pvary(t, ax))

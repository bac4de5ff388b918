"""Device-mesh helpers (counterpart of `stheno_tpu/parallel/mesh.py`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named axes over
the ranks of the job, on `cuda` (NCCL) unless the caller asks for `cpu`
(gloo).  Two axes cover the workloads:

- `('chains',)`: NUTS chains and SMC particles (collectives only for
  resampling and diagnostics);
- `('rows',)`: big-N exact GPs: kernel-matrix rows, distributed Cholesky
  panels, triangular solves, the ring.

A process with no group gets a one-rank group of its own.  On a machine
with one card a mesh has one rank: NCCL does not run two ranks on one GPU.
"""

from __future__ import annotations

from stheno_tpu_torch.parallel.collectives import Axis, shard
from stheno_tpu_torch.parallel.multihost import global_mesh


def _mesh_1d(name, n_devices, device_type):
    mesh = global_mesh((name,), device_type=device_type)
    if n_devices is not None and n_devices != mesh.size():
        raise ValueError(
            f"a {name!r} mesh spans the job's {mesh.size()} ranks, not {n_devices}: "
            "start that many processes")
    return mesh


def chains_mesh(n_devices=None, device_type="cuda"):
    return _mesh_1d("chains", n_devices, device_type)


def rows_mesh(n_devices=None, device_type="cuda"):
    return _mesh_1d("rows", n_devices, device_type)


def grid_mesh(n_chains_axis, n_rows_axis, device_type="cuda"):
    """2-D mesh: chains × rows: chains sharded over one axis, each chain's
    big-N linear algebra over the other."""
    return global_mesh(("chains", "rows"), (n_chains_axis, n_rows_axis), device_type=device_type)


def shard_rows(mesh, x, axis_name="rows"):
    """This rank's slab of the leading axis of `x` (given whole on every
    rank): rows [r·N/P, (r+1)·N/P)."""
    return shard(x, Axis(mesh, axis_name))

"""Multi-process orchestration (counterpart of
`stheno_tpu/parallel/multihost.py`): `torch.distributed` with NCCL on the
card, gloo on the CPU.

Usage on each process of a job:

    from stheno_tpu_torch.parallel import multihost
    multihost.initialize()                 # from torchrun's environment
    mesh = multihost.global_mesh(("chains",))
    ...run_nuts_sharded(..., mesh=mesh)   # chains spread over every rank

Nothing on a machine tells a program of a cluster: give `initialize` the
rendezvous (`tcp://host:port` or `file:///path`), the world size and the
rank, or start the processes with `torchrun`, which sets `RANK`,
`WORLD_SIZE` and `MASTER_ADDR`.  With neither, the process stays local and
the mesh helpers make a one-rank group of their own.  Checkpointing pairs
with `inference.checkpoint`: `save_on_host0` writes one copy.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

#: Store, collective and join timeout of a group made here.
TIMEOUT = datetime.timedelta(seconds=300)


def backend_for(device_type):
    """NCCL on the card, gloo on the CPU."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "stheno_tpu_torch.parallel: no CUDA device is available; pass "
                "device_type='cpu' for a gloo group on the CPU")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")


def _init(backend, device_type, timeout, **kwargs):
    if device_type == "cuda":
        # one card a rank: torchrun's LOCAL_RANK, else the rank, modulo the cards
        local = int(os.environ.get("LOCAL_RANK", kwargs.get("rank", 0)))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    # a failed initialisation raises; nothing falls back to another backend
    dist.init_process_group(backend, timeout=timeout, **kwargs)


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device_type="cuda", timeout=TIMEOUT):
    """Join the job's process group.  With `coordinator_address` (an
    `init_method`: `tcp://host:port` or `file:///path`), `num_processes` and
    `process_id` given, from those; else from torchrun's environment; with
    neither, stay local (no group).  Safe to call when already
    initialised."""
    if dist.is_initialized():
        return
    backend = backend_for(device_type)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("initialize: coordinator_address needs num_processes and process_id")
        _init(backend, device_type, timeout, init_method=coordinator_address,
              world_size=int(num_processes), rank=int(process_id))
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        _init(backend, device_type, timeout, init_method="env://")


def ensure_group(device_type="cuda"):
    """The default group, made as a local one-rank group on an in-memory
    store when the process has none (a single-process run)."""
    backend = backend_for(device_type)
    if not dist.is_initialized():
        _init(backend, device_type, TIMEOUT, store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_backend() != backend:
        raise RuntimeError(
            f"the process group runs {dist.get_backend()}, not {backend} for {device_type!r}")


def global_mesh(axis_names=("chains",), axis_shape=None, device_type="cuda"):
    """A mesh over every rank of the job: 1-D by default; `axis_shape` for
    multi-axis layouts, e.g. `global_mesh(("chains", "rows"), (hosts,
    cards_per_host))` so the 'rows' collectives stay within a host."""
    from torch.distributed.device_mesh import init_device_mesh

    ensure_group(device_type)
    world = dist.get_world_size()
    if axis_shape is None:
        if len(axis_names) != 1:
            raise ValueError("provide axis_shape for multi-axis meshes")
        axis_shape = (world,)
    if int(np.prod(axis_shape)) != world:
        raise ValueError(f"mesh shape {tuple(axis_shape)} does not cover the {world} ranks")
    return init_device_mesh(device_type, tuple(axis_shape), mesh_dim_names=tuple(axis_names))


def is_host0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def save_on_host0(path, tree, step=None):
    """Write a checkpoint once per job (every rank holds the replicated
    state; rank 0 writes)."""
    from stheno_tpu_torch.inference.checkpoint import save_checkpoint

    if is_host0():
        save_checkpoint(path, tree, step=step)

"""Sampler-state checkpoint and resume (counterpart of
`stheno_tpu/inference/checkpoint.py`).

Format: a directory holding `leaves.npz` (the tree's tensors through numpy,
`leaf_0`, `leaf_1`, … in flatten order) and `meta.json` with the structure
record of the reference: for each leaf its path (`.q`, `['a']`, `[0]`), its
shape and its dtype, compared field by field on load.  A tree is made of
NamedTuples (`ChainState`, `WarmupState`, `SMCCheckpoint`), dicts, lists and
tuples of tensors (`tree.tree_leaves_with_path`).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from stheno_tpu_torch.tree import tree_leaves_with_path, tree_unflatten


def _as_numpy(leaf):
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _structure_record(tree):
    """[{path, shape, dtype}, ...] in flatten order: the stored digest."""
    return [{"path": p, "shape": list(np.shape(a)), "dtype": str(a.dtype)}
            for p, a in ((p, _as_numpy(leaf)) for p, leaf in tree_leaves_with_path(tree))]


def _check_structure(stored, expected):
    if len(stored) != len(expected):
        raise ValueError(f"checkpoint has {len(stored)} leaves, expected {len(expected)}")
    for s, e in zip(stored, expected):
        if s["path"] != e["path"]:
            raise ValueError(
                "checkpoint structure does not match the `like` tree: "
                f"stored leaf at {s['path']!r}, expected {e['path']!r}")
        if list(s["shape"]) != list(e["shape"]):
            raise ValueError(f"checkpoint leaf {s['path']!r} has shape {s['shape']}, "
                             f"expected {e['shape']}")
        if s["dtype"] != e["dtype"]:
            raise ValueError(f"checkpoint leaf {s['path']!r} has dtype {s['dtype']}, "
                             f"expected {e['dtype']}")


def save_checkpoint(path: str, tree, step: int | None = None):
    """Write a tree of tensors to `path` (a directory)."""
    os.makedirs(path, exist_ok=True)
    leaves = [_as_numpy(leaf) for _, leaf in tree_leaves_with_path(tree)]
    np.savez(os.path.join(path, "leaves.npz"), **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    meta = {"num_leaves": len(leaves), "structure": _structure_record(tree)}
    if step is not None:
        meta["step"] = int(step)
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def load_checkpoint(path: str, like):
    """Read a checkpoint written by `save_checkpoint` into a tree of the
    structure of `like`, each tensor on the device of `like`'s leaf in its
    place.  A stored structure that differs from `like`'s in a leaf's
    path, shape or dtype, or in the number of leaves, is refused (a
    structure of the same arity would otherwise scramble the leaves)."""
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    _check_structure(meta["structure"], _structure_record(like))
    with np.load(os.path.join(path, "leaves.npz")) as data:
        arrays = [data[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    leaves = [torch.as_tensor(a, device=leaf.device if torch.is_tensor(leaf) else None)
              for a, (_, leaf) in zip(arrays, tree_leaves_with_path(like))]
    return tree_unflatten(like, leaves)


def checkpoint_step(path: str) -> int | None:
    """The `step` stored with a checkpoint, or None (none stored, or no
    checkpoint at `path`)."""
    try:
        with open(os.path.join(path, "meta.json")) as fh:
            return json.load(fh).get("step")
    except FileNotFoundError:
        return None

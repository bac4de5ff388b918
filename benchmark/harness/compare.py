"""The numbers that decide `correct`, each worked out between what the timed
path produced and what the plain reference gives for the same inputs.

Training numbers are taken leaf by leaf (a leaf is one named piece of the
flat θ) and the worst leaf counts.  A gap is measured against the larger
of the reference's norm of that leaf and the median leaf's norm, since a
gradient can be all but zero on one leaf.
"""

from __future__ import annotations

import statistics

import torch


def split(vec, leaves):
    """The flat vector `vec` cut into its leaves (float64, on the CPU)."""
    vec = torch.as_tensor(vec).detach().to(device="cpu", dtype=torch.float64).reshape(-1)
    sizes = [size for _, size in leaves]
    if vec.numel() != sum(sizes):
        raise ValueError(f"a vector of {vec.numel()} values for leaves of {sizes}")
    return list(torch.split(vec, sizes))


def _scales(ref_parts):
    norms = [float(torch.linalg.vector_norm(r)) for r in ref_parts]
    med = statistics.median(norms)
    return norms, med


def worst_gap_of_norms(prog, ref, leaves, keep=None):
    """max over the kept leaves of |‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    p_parts, r_parts = split(prog, leaves), split(ref, leaves)
    norms, med = _scales(r_parts)
    gaps = [abs(float(torch.linalg.vector_norm(p)) - n) / max(n, med)
            for i, (p, n) in enumerate(zip(p_parts, norms)) if keep is None or keep[i]]
    return max(gaps) if gaps else 0.0


def worst_difference(prog, ref, leaves):
    """max over the leaves of ‖prog − ref‖ / max(‖ref‖, median ‖ref‖)."""
    p_parts, r_parts = split(prog, leaves), split(ref, leaves)
    norms, med = _scales(r_parts)
    return max(float(torch.linalg.vector_norm(p - r)) / max(n, med)
               for p, r, n in zip(p_parts, r_parts, norms))


def moved_leaves(ref_grad, leaves, share=1e-3):
    """Which leaves the reference's gradient moves: those whose norm is at
    least `share` of the median leaf's (a key's bias under softmax, say,
    moves under Adam by round-off alone and is left out)."""
    norms, med = _scales(split(ref_grad, leaves))
    return [n >= share * med for n in norms]


def relative_gap(prog, ref):
    return abs(float(prog) - float(ref)) / abs(float(ref))


def max_relative(prog, ref, scale):
    """max |prog − ref| over max |scale|."""
    prog = torch.as_tensor(prog, dtype=torch.float64)
    ref = torch.as_tensor(ref, dtype=torch.float64)
    return float((prog - ref).abs().max()) / float(torch.as_tensor(scale, dtype=torch.float64).abs().max())


def verdict(checks):
    """`correct`: every compared number is finite and within its limit."""
    return all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks)

"""Cost summaries per entry point (counterpart of `stheno_tpu/utils/cost.py`).

The reference asks XLA's cost model of a compiled function.  PyTorch runs
eagerly, so this runs the function once and counts as it goes: FLOPs by
`torch.utils.flop_counter.FlopCounterMode` (matrix products, convolutions
and attention: the ops it has formulas for; elementwise work, the kernels'
own launches and the factorisations are not counted), and bytes as the
sum over every op of its tensor inputs' and outputs' sizes, the same kind
of upper bound as XLA's "bytes accessed" (no fusion, no reuse in cache).
"""

from __future__ import annotations

import sys

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode


class _ByteCounter(TorchDispatchMode):
    """Σ over ops of the bytes of their tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree.tree_leaves((args, kwargs, out)):
            if torch.is_tensor(t):
                self.bytes += t.numel() * t.element_size()
        return out


def cost_analysis(fn, *args, **kwargs):
    """Run `fn(*args, **kwargs)` once and return its costs:
    {'flops': …, 'bytes accessed': …, 'flops_by_op': {op: flops}}."""
    with FlopCounterMode(display=False) as flops, _ByteCounter() as nbytes:
        fn(*args, **kwargs)
    by_op = {}
    for ops in flops.get_flop_counts().values():
        for op, n in ops.items():
            by_op[str(op)] = max(by_op.get(str(op), 0), n)
    return {"flops": float(flops.get_total_flops()), "bytes accessed": float(nbytes.bytes),
            "flops_by_op": by_op}


def cost_summary(fn, *args, peak_flops=None, hbm_bw=None, name="entry", file=sys.stderr, **kwargs):
    """Print a one-line roofline summary of an entry point:

        [cost] logpdf-16k  flops=2.93e+12  bytes=4.3e+09  intensity=682  model-compute-bound 43.7 ms

    `peak_flops` (FLOP/s) and `hbm_bw` (B/s) are the card's; with both the
    bound is max(flops/peak, bytes/bw).  'model-' because the byte count is
    an upper bound (module docstring).  Returns the cost dict."""
    ca = cost_analysis(fn, *args, **kwargs)
    flops, byts = ca["flops"], ca["bytes accessed"]
    parts = [f"flops={flops:.3g}", f"bytes={byts:.3g}"]
    if byts > 0:
        parts.append(f"intensity={flops / byts:.1f}")
    if peak_flops and hbm_bw and (flops or byts):
        t = max(flops / peak_flops, byts / hbm_bw)
        kind = "compute" if flops / peak_flops >= byts / hbm_bw else "memory"
        parts.append(f"model-{kind}-bound {t * 1e3:.2f} ms")
    print(f"[cost] {name}  " + "  ".join(parts), file=file, flush=True)
    return ca

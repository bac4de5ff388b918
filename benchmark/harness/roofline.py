"""The yardstick's peaks and least times (a frozen copy of `chip_smoke.py`'s
`bound` and of the H100's published peaks, kept here so that a change to
the program cannot move it).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the full
700 W power limit): HBM bandwidth 3.35 TB/s, float32 67 TFLOP/s outside the
tensor cores.  The configurations state float32 with TF32 off, so their
products run outside the tensor cores and 67 TFLOP/s is their ceiling.

Kernel 1 (the pairwise kernel matrix, `csrc/kernelmatrix.cu`) is bounded
per launch by what the problem of that launch must move or compute:

- forward, an (n, m) matrix of points of dimension d: write the n·m outputs
  and read the (n + m)·d coordinates once (n·d for a same-input launch), or
  3d + 7 operations an element, whichever takes longer;
- VJP: read the n·m cotangent once and each coordinate once and write its
  gradient once, or 6d + 15 operations an element, whichever takes longer.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_s(nbytes, flops, flop_rate=FP32_FLOP_PER_S):
    """`(least seconds, what sets it)`: bytes over the HBM bandwidth or
    operations over `flop_rate`, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def km_forward_least_s(n, m, d, same, itemsize, batch=1):
    """Least time of one kernel-1 forward launch: `batch` matrices of n × m."""
    points = n if same else n + m
    nbytes = batch * (n * m + points * d) * itemsize
    return bound_s(nbytes, batch * n * m * (3 * d + 7))[0]


def km_vjp_least_s(n, m, d, same, itemsize, batch=1):
    """Least time of one kernel-1 VJP launch: `batch` cotangents of n × m."""
    points = n if same else n + m
    nbytes = batch * (n * m + 2 * points * d) * itemsize
    return bound_s(nbytes, batch * n * m * (6 * d + 15))[0]

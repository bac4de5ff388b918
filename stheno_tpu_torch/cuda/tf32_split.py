"""The TF32 split of an f32 tensor, the one kernel of the 'high' GEMM
precision: hi = rna_tf32(x) (round to nearest, ties away from zero, to
TF32's 10 explicit mantissa bits), lo = x − hi.

No TPU kernel is replaced: on the TPU, XLA splits the operands of a HIGH
(bf16_3x) dot itself.  On the card the split feeds 3xTF32 products
(`ops/blocked_cholesky.py:_mm`), and is the CUDA kernel of
`csrc/tf32_split.cu`: one read and two writes of f32, so bound by bytes
(12 bytes an element over the card's memory rate).  See the source for the
design.

`tf32_split_plain` is its plain version, which rounds with integer
operations on the bits, `(bits + 0x1000) & ~0x1FFF`, on finite values.  The
two agree bit for bit:

- a finite x whose rounding carries past the largest float (|x| ≥
  (2 − 2⁻¹¹)·2¹²⁷) gives hi = ±inf and lo = x − hi = ∓inf in both, as the
  instruction rounds such a value to infinity;
- subnormals round like any other value (the instruction does not flush
  them), and lo = x − hi is exact for them too;
- ±inf and NaN pass through to hi, with lo = +0.

Elsewhere lo is exact, |lo| ≤ 2⁻¹¹|x|, and hi has its low 13 bits zero.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from stheno_tpu_torch.cuda import _build

#: Launches of the split kernel, by (rows, cols, ld).
SPLIT_LAUNCHES = _build.LaunchCounter("tf32_split")

#: TF32 keeps 10 of f32's 23 mantissa bits: the low 13 are dropped
_HALF = 0x1000
_MASK = ~0x1FFF


def tf32_split_plain(x):
    """(hi, lo) of f32 `x` by integer rounding of its bits (see the module
    note); any shape, contiguous outputs."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_split: takes float32, got {x.dtype}")
    x = x.contiguous()
    finite = torch.isfinite(x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    # the bits of a NaN could overflow int32 here: only finite values round
    bits = torch.where(finite, x, zero).view(torch.int32)
    hi = torch.where(finite, ((bits + _HALF) & _MASK).view(torch.float32), x)
    lo = torch.where(finite, x - hi, zero)
    return hi, lo


def tf32_round_plain(x):
    """hi of `tf32_split_plain(x)`: x rounded to TF32."""
    return tf32_split_plain(x)[0]


_entry_fn = None


def _entry():
    global _entry_fn
    if _entry_fn is None:
        fn = _build.library("tf32_split").stheno_tf32_split_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry_fn = fn
    return _entry_fn


def _launch(x, rows, cols, ld):
    """Launch the kernel on f32 `x` read as `rows` rows of `cols` floats,
    `ld` apart; returns contiguous (rows, cols) hi and lo."""
    hi = torch.empty((rows, cols), dtype=x.dtype, device=x.device)
    lo = torch.empty_like(hi)
    if rows * cols == 0:
        return hi, lo
    here = x.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(x.device):
        code = _entry()(x.data_ptr(), hi.data_ptr(), lo.data_ptr(), rows, cols, ld,
                        torch.cuda.current_stream().cuda_stream)
    if code:
        _build.check(_build.library("tf32_split"), code, "tf32_split launch")
    SPLIT_LAUNCHES.add((rows, cols, ld))
    return hi, lo


def tf32_split(x):
    """(hi, lo) of f32 `x`, hi + lo = x.  A 2-D operand with unit stride
    along its rows or its columns (a slice or a transpose of a matrix) is
    read in place; anything else is made contiguous first.  The outputs have
    x's shape; for a transposed operand they are transposed views."""
    if not x.is_cuda:
        return tf32_split_plain(x)
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_split: the CUDA kernel takes float32, got {x.dtype}")
    if x.dim() == 2 and not x.is_contiguous():
        if x.stride(1) == 1 and x.stride(0) >= x.shape[1]:
            hi, lo = _launch(x, x.shape[0], x.shape[1], x.stride(0))
            return hi, lo
        if x.stride(0) == 1 and x.stride(1) >= x.shape[0]:
            hi, lo = tf32_split(x.mT)
            return hi.mT, lo.mT
    x = x.contiguous()
    hi, lo = _launch(x, 1, x.numel(), x.numel())
    return hi.view(x.shape), lo.view(x.shape)

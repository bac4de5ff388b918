"""Kernels 2 and 3: Cholesky factor and triangular inverse of a batch of small
f32 blocks, the base cases of the blocked Cholesky.

Replace the Pallas kernels `stheno_tpu/experimental/pallas/chol_block.py`
(`chol_block`, `tri_inv_block`) with the CUDA kernels in
`csrc/chol_block.cu`, one CTA per block of the batch.  On an H100 neither is
bound by the card's bytes or flops at the main path's 256×256 blocks: what
bounds them is one SM's latency along a chain of dependent steps.  The
kernels keep the packed working triangle in shared memory for the whole
sweep, so no step touches device memory; the inverse gives each thread one
column and needs no barrier.  See the source for the design.

On a CPU tensor each wrapper runs its plain PyTorch version, which repeats
the kernel's sweep; on a CUDA tensor it launches the kernel or raises (for
a dtype other than f32, or a block whose triangle does not fit in shared
memory: n ≤ 339 for kernel 2, n ≤ 337 for kernel 3).
"""

from __future__ import annotations

import ctypes

import torch

from stheno_tpu_torch.cuda import _build

#: Launches of each CUDA kernel, by (batch, n).
CHOL_LAUNCHES = _build.LaunchCounter("chol_block")
TRI_INV_LAUNCHES = _build.LaunchCounter("tri_inv_block")

#: Dynamic shared memory one CTA may use on sm_90 (227 KiB).
SMEM_LIMIT = 232448


def _tri_inv_staging(n):
    """Floats kernel 3 stages beside its triangle: 4 rows × 32 entries of L
    per warp, ≤ 8 warps."""
    return 4 * min(256, -(-n // 32) * 32)


def _fits(n, extra):
    return (n * (n + 1) // 2 + extra) * 4 <= SMEM_LIMIT


def fits(n):
    """Whether kernels 2 and 3 both take n×n blocks: the packed triangle
    and their working floats fit in shared memory."""
    return _fits(n, n) and _fits(n, _tri_inv_staging(n))


def chol_block_plain(A):
    """Right-looking column sweep over tril(A), batched over leading dims:
    L[k:, k] = A[k:, k]·rsqrt(A[k, k]), then A[i, j] −= L[i, k]·L[j, k].
    A non-positive pivot gives NaN (never raises)."""
    S = torch.tril(A).clone()
    n = S.shape[-1]
    for k in range(n):
        piv = S[..., k, k]
        s = torch.where(piv > 0, torch.rsqrt(piv), torch.full_like(piv, float("nan")))
        S[..., k:, k] *= s[..., None]
        col = S[..., k + 1:, k]
        S[..., k + 1:, k + 1:] -= col[..., :, None] * col[..., None, :]
    return torch.tril(S)


def tri_inv_block_plain(L):
    """Row sweep M[i, :] = (e_i − L[i, :i]·M[:i, :]) / L[i, i] for the
    inverse of lower-triangular L, batched over leading dims."""
    n = L.shape[-1]
    M = torch.zeros_like(L)
    for i in range(n):
        acc = (L[..., i, None, :i] @ M[..., :i, : i + 1])[..., 0, :]
        e = torch.zeros_like(acc)
        e[..., i] = 1.0
        M[..., i, : i + 1] = (e - acc) / L[..., i, i, None]
    return M


def _launch(name: str, counter, A, extra: int):
    """Launch `stheno_<name>_f32` on contiguous (batch, n, n) f32 `A`; its
    packed triangle and `extra` more floats live in shared memory."""
    if A.dim() != 3 or A.shape[1] != A.shape[2] or not A.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous (batch, n, n) tensor, got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {A.dtype}")
    batch, n, _ = A.shape
    if not _fits(n, extra):
        raise ValueError(f"{name}: the packed triangle of a {n}×{n} block does not fit "
                         f"in {SMEM_LIMIT} bytes of shared memory")
    out = torch.empty_like(A)
    lib = _build.library("chol_block")
    fn = getattr(lib, f"stheno_{name}_f32")
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(A.data_ptr(), out.data_ptr(), batch, n, stream)
    _build.check(lib, code, f"{name} launch")
    counter.add((batch, n))
    return out


def chol_block(A):
    """Lower Cholesky factor of each PSD block of A ((n, n) or (batch, n, n)),
    reading tril(A) only."""
    if not A.is_cuda:
        return chol_block_plain(A)
    if A.dim() == 2:
        return chol_block(A[None])[0]
    return _launch("chol_block", CHOL_LAUNCHES, A.contiguous(), extra=A.shape[-1])


def tri_inv_block(L):
    """Inverse of each lower-triangular block of L ((n, n) or (batch, n, n))."""
    if not L.is_cuda:
        return tri_inv_block_plain(L)
    if L.dim() == 2:
        return tri_inv_block(L[None])[0]
    return _launch("tri_inv_block", TRI_INV_LAUNCHES, L.contiguous(), extra=_tri_inv_staging(L.shape[-1]))

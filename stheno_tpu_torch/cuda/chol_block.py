"""Kernels 2 and 3: Cholesky factor and triangular inverse of a batch of small
f32 blocks, the base cases of the blocked Cholesky.

Replace the Pallas kernels `stheno_tpu/experimental/pallas/chol_block.py`
(`chol_block`, `tri_inv_block`) with the CUDA kernels in
`csrc/chol_block.cu`, one CTA per block of the batch.  On an H100 neither is
bound by the card's bytes or flops at the main path's 256×256 blocks: each
block runs on one SM, so one SM's fp32 rate (n³/3 flops: 0.011 ms at
n = 256) and the chain of dependent diagonal steps bound them.  Both keep the
block's lower 32×32 tiles in shared memory.  Kernel 2 is a tiled
right-looking Cholesky (diagonal tile in one warp, panel solve,
register-blocked trailing update); kernel 3 inverts every diagonal tile at
once, one warp each, then sweeps right-looking over tile columns with
register-blocked tile products, writing M over L in place.  See the source
for the design.

On a CPU tensor each wrapper runs its plain PyTorch version, which repeats
the kernel's order of operations; on a CUDA tensor it launches the kernel or
raises (for a dtype other than f32, or a block whose working set does not
fit in shared memory: n ≤ 288 for both kernels).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from stheno_tpu_torch.cuda import _build

#: Launches of each CUDA kernel, by (batch, n).
CHOL_LAUNCHES = _build.LaunchCounter("chol_block")
TRI_INV_LAUNCHES = _build.LaunchCounter("tri_inv_block")

#: Dynamic shared memory one CTA may use on sm_90 (227 KiB).
SMEM_LIMIT = 232448


#: Tile edge of kernels 2 and 3 (`csrc/chol_block.cu:kT`).
TILE = 32


def _smem_bytes(name, n):
    """Dynamic shared memory of kernel `name` for an n×n block: a copy of
    `stheno_<name>_smem_bytes` in `csrc/chol_block.cu` (see
    `library_smem_bytes`), so that `fits` answers without a build."""
    nt = -(-n // TILE)
    if name == "chol_block":
        # the lower tiles, the transposed panel (nt − 1 tiles), the diagonal
        # tile's factor transposed, two broadcast rows and the pivots' rsqrts
        return ((nt * (nt + 1) // 2 + nt) * TILE * TILE + 3 * TILE) * 4
    # the lower tiles, the transposed panel (nt − 1 tiles) and one diagonal
    # tile's inverse transposed
    return (nt * (nt + 1) // 2 + nt) * TILE * TILE * 4


def library_smem_bytes(name, n):
    """Dynamic shared memory of kernel `name` for an n×n block, as the built
    library computes it (builds the library: needs nvcc)."""
    fn = getattr(_build.library("chol_block"), f"stheno_{name}_smem_bytes")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(n)


def _fits(name, n):
    """Whether kernel `name` takes n×n blocks in one CTA's shared memory."""
    return _smem_bytes(name, n) <= SMEM_LIMIT


def fits(n):
    """Whether kernels 2 and 3 both take n×n blocks."""
    return _fits("chol_block", n) and _fits("tri_inv_block", n)


def chol_block_plain(A):
    """Tiled right-looking Cholesky of tril(A), batched over leading dims, in
    the kernel's order: A is padded to whole TILE×TILE tiles with the
    identity; for each tile column k the diagonal tile is factored by a
    column sweep (L[j:, j] = S[j:, j]·s_j with s_j = rsqrt(S[j, j])), the
    panel below it solved by substitution (x_j = a_j·s_j, then a_c −=
    x_j·L[c, j]), and the trailing tiles take S −= P·Pᵀ.  A non-positive
    pivot gives NaN (never raises)."""
    n = A.shape[-1]
    nt = -(-n // TILE)
    npad = nt * TILE
    S = torch.zeros(*A.shape[:-2], npad, npad, dtype=A.dtype, device=A.device)
    S[..., :n, :n] = torch.tril(A)
    S.diagonal(dim1=-2, dim2=-1)[..., n:] = 1.0
    nan = torch.tensor(float("nan"), dtype=A.dtype, device=A.device)
    for k in range(nt):
        lo, hi = k * TILE, (k + 1) * TILE
        D = S[..., lo:hi, lo:hi]
        P = S[..., hi:, lo:hi]
        s = []
        for j in range(TILE):
            piv = D[..., j, j]
            s.append(torch.where(piv > 0, torch.rsqrt(piv), nan))
            D[..., j:, j] *= s[j][..., None]
            col = D[..., j + 1:, j]
            D[..., j + 1:, j + 1:] -= col[..., :, None] * col[..., None, :]
        for j in range(TILE):
            P[..., :, j] *= s[j][..., None]
            P[..., :, j + 1:] -= P[..., :, j, None] * D[..., None, j + 1:, j]
        S[..., hi:, hi:] -= P @ P.mT
    return torch.tril(S[..., :n, :n])


def tri_inv_block_plain(L):
    """Inverse of lower-triangular tril(L), batched over leading dims, in the
    kernel's order: L is padded to whole TILE×TILE tiles with the identity;
    every diagonal tile is inverted by a row sweep (M[i, :] = (e_i −
    L[i, :i]·M[:i, :]) / L[i, i]); then for each tile column k, every tile
    below tile row k takes S_ij −= L_ik·M_kj (j ≤ k), and tile row k + 1
    of M is M_{k+1,k+1}·S_{k+1,j}.  A zero pivot gives inf or NaN."""
    n = L.shape[-1]
    nt = -(-n // TILE)
    npad = nt * TILE
    Lp = torch.zeros(*L.shape[:-2], npad, npad, dtype=L.dtype, device=L.device)
    Lp[..., :n, :n] = torch.tril(L)
    Lp.diagonal(dim1=-2, dim2=-1)[..., n:] = 1.0
    D = torch.stack([Lp[..., k * TILE:(k + 1) * TILE, k * TILE:(k + 1) * TILE]
                     for k in range(nt)], dim=-3)
    Md = torch.zeros_like(D)
    for i in range(TILE):
        acc = (D[..., i, None, :i] @ Md[..., :i, : i + 1])[..., 0, :]
        e = torch.zeros_like(acc)
        e[..., i] = 1.0
        Md[..., i, : i + 1] = (e - acc) / D[..., i, i, None]
    M = torch.zeros_like(Lp)
    for k in range(nt):
        M[..., k * TILE:(k + 1) * TILE, k * TILE:(k + 1) * TILE] = Md[..., k, :, :]
    S = torch.zeros_like(Lp)
    for k in range(nt - 1):
        lo, hi, nxt = k * TILE, (k + 1) * TILE, (k + 2) * TILE
        S[..., hi:, :hi] -= Lp[..., hi:, lo:hi] @ M[..., lo:hi, :hi]
        M[..., hi:nxt, :hi] = M[..., hi:nxt, hi:nxt] @ S[..., hi:nxt, :hi]
    return M[..., :n, :n]


#: The C launch functions, bound once per loaded library.
_entries = {}


def _entry(name):
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.library("chol_block"), f"stheno_{name}_f32")
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _launch(name: str, counter, A):
    """Launch `stheno_<name>_f32` on contiguous (batch, n, n) f32 `A`.  The
    C side raises the kernel's shared-memory limit on a device only when a
    block needs more than it set there before; the device guard is entered
    only when `A` is not on the current device."""
    if A.dim() != 3 or A.shape[1] != A.shape[2] or not A.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous (batch, n, n) tensor, got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {A.dtype}")
    batch, n, _ = A.shape
    if not _fits(name, n):
        raise ValueError(f"{name}: a {n}×{n} block needs {_smem_bytes(name, n)} bytes of "
                         f"shared memory, more than the {SMEM_LIMIT} one CTA may use")
    out = torch.empty_like(A)
    fn = _entry(name)
    here = A.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(A.device):
        code = fn(A.data_ptr(), out.data_ptr(), batch, n, torch.cuda.current_stream().cuda_stream)
    if code:
        _build.check(_build.library("chol_block"), code, f"{name} launch")
    counter.add((batch, n))
    return out


def chol_block(A):
    """Lower Cholesky factor of each PSD block of A ((n, n) or (batch, n, n)),
    reading tril(A) only."""
    if not A.is_cuda:
        return chol_block_plain(A)
    if A.dim() == 2:
        return chol_block(A[None])[0]
    return _launch("chol_block", CHOL_LAUNCHES, A.contiguous())


def tri_inv_block(L):
    """Inverse of each lower-triangular block of L ((n, n) or (batch, n, n))."""
    if not L.is_cuda:
        return tri_inv_block_plain(L)
    if L.dim() == 2:
        return tri_inv_block(L[None])[0]
    return _launch("tri_inv_block", TRI_INV_LAUNCHES, L.contiguous())

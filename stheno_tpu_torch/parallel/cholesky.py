"""Distributed blocked Cholesky, triangular solves and logpdf over a
row-sharded mesh axis (counterpart of `stheno_tpu/parallel/cholesky.py`).

Layout: K (N, N) with rows block-sharded over the axis `rows`: rank r holds
the contiguous slab of rows [r·N/P, (r+1)·N/P) (`K_loc`, (N/P, N)).
Right-looking panel algorithm, the panel loop unrolled in Python (N/B
steps), every trailing-update GEMM on the exact trailing column slice:

  for each B-column panel k (c = k·B):
    1. every rank takes its (possibly empty) slice of the diagonal block;
       a `psum` assembles it everywhere;
    2. L_kk = chol(diag), computed on every rank (`ops.chol.cholesky_psd`,
       `torch.linalg` at B < 4096, as the reference's goes to
       `lax.linalg`);
    3. each rank solves its panel rows against L_kk;
    4. `all_gather` of the panel column (N·B), the only O(N) traffic;
    5. trailing update of the local rows below the panel: one
       (n_loc × B) @ (B × N−c−B) GEMM.

Per-rank cost ≈ N³/(2P) multiply-adds for the contiguous slab;
`distributed_cholesky_cyclic` deals B-row blocks round robin (global block
g on rank g mod P) for ≈ N³/(3P), and `distributed_cholesky_auto` takes it
whenever divisibility allows.  Every GEMM goes through
`ops.blocked_cholesky._mm`, as in the reference: at the scoped
`config.gemm_precision`, full FP32 (TF32 off) at the port's default
'highest'.

The updates are out of place, so autograd differentiates the loop: the
finished column panels are kept and concatenated at the end, and the
trailing matrix is replaced by `trailing[:, B:] − update` each panel (its
GEMM saves only the O(N·B) panel and trail).  Rank-dependent choices are
masks (`torch.where`), so every rank builds the same graph; see
`collectives` for the gradient rules.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stheno_tpu_torch.ops import chol as _chol
from stheno_tpu_torch.ops.blocked_cholesky import _mm
from stheno_tpu_torch.parallel.collectives import (
    Axis,
    all_gather,
    all_to_all,
    psum,
    pvary,
)


def _local_slab(n, p):
    if n % p != 0:
        raise ValueError(f"N={n} must divide evenly over {p} devices (pad first)")
    return n // p


def _flag(cond, device):
    return torch.tensor(bool(cond), device=device)


def _assemble_diag_block(M_loc, c, B, row_base, ax):
    """psum-assemble the (B, B) diagonal block at global offset c of the
    row-sharded M: each rank contributes its slice or zeros."""
    n_loc = M_loc.shape[0]
    start = min(max(c - row_base, 0), n_loc - B)
    mine = _flag(row_base <= c and c + B <= row_base + n_loc, M_loc.device)
    contrib = M_loc[start:start + B, c:c + B]
    return psum(torch.where(mine, contrib, torch.zeros_like(contrib)), ax)


def _chol_panel_loop(K_loc, B, ax, n_total):
    """The slab factorisation of this rank's rows."""
    n_loc = K_loc.shape[0]
    dev = K_loc.device
    row_base = ax.rank * n_loc
    local_rows = row_base + torch.arange(n_loc, device=dev)
    trailing = K_loc  # columns [c, N) of the matrix being factored
    panels = []
    for kb in range(n_total // B):
        c = kb * B
        # -- 1+2: the diagonal block everywhere, factored -------------------
        # (the trailing matrix's column 0 is global column c)
        L_kk = pvary(_chol.cholesky_psd(_assemble_diag_block(trailing, 0, B, row_base - c, ax)), ax)
        # -- 3: solve the local panel rows ------------------------------------
        panel = trailing[:, :B]
        P_loc = _chol.solve_lower(L_kk, panel.T).T
        # rows inside the diagonal block take L_kk's rows; rows above c are
        # final (zero in these columns); rows below take the solve
        in_diag = ((local_rows >= c) & (local_rows < c + B))[:, None]
        below = (local_rows >= c + B)[:, None]
        diag_rows = L_kk[torch.clamp(local_rows - c, 0, B - 1)]
        new_panel = torch.where(in_diag, diag_rows,
                                torch.where(below, P_loc, torch.zeros_like(P_loc)))
        panels.append(new_panel)
        if c + B >= n_total:
            break
        # -- 4: the whole panel column; 5: the trailing update ----------------
        trail = pvary(all_gather(new_panel, ax)[c + B:], ax)  # (N - c - B, B)
        update = _mm(torch.where(below, new_panel, torch.zeros_like(new_panel)), trail.T)
        trailing = trailing[:, B:] - update
    # rows above each panel are zero in it and L_kk is lower triangular:
    # the concatenation is already the lower factor's slab
    return torch.cat(panels, dim=1)


def distributed_cholesky(mesh, K, block_size=128, axis_name="rows"):
    """Lower Cholesky factor of a PSD matrix whose rows are sharded over
    `axis_name`: `K` is this rank's (N/P, N) slab; returns its slab of L."""
    ax = Axis(mesh, axis_name)
    n = K.shape[1]
    n_loc = _local_slab(n, ax.size)
    if K.shape[0] != n_loc:
        raise ValueError(f"K slab has {K.shape[0]} rows; expected N/P = {n_loc}")
    if n % block_size != 0:
        raise ValueError(f"N={n} must be a multiple of block_size={block_size}")
    if n_loc % block_size != 0:
        raise ValueError(
            f"local slab {n_loc} must be a multiple of block_size={block_size} "
            "(diagonal blocks may not straddle devices)")
    return _chol_panel_loop(K, block_size, ax, n)


def _fwd_solve_loop(L_loc, b_loc, B, ax, n_total):
    """Solve L a = b (L lower, rows sharded; b sharded the same way, (n_loc,)
    or (n_loc, K)).  Returns `a` invariant."""
    n_loc = L_loc.shape[0]
    dev = L_loc.device
    row_base = ax.rank * n_loc
    local_rows = row_base + torch.arange(n_loc, device=dev)
    vec = b_loc.dim() == 1
    r_loc = b_loc[:, None] if vec else b_loc
    blocks = []
    for k in range(n_total // B):
        c = k * B
        Lkk = _assemble_diag_block(L_loc, c, B, row_base, ax)
        start = min(max(c - row_base, 0), n_loc - B)
        mine = _flag(row_base <= c and c + B <= row_base + n_loc, dev)
        r_part = r_loc[start:start + B]
        r_blk = psum(torch.where(mine, r_part, torch.zeros_like(r_part)), ax)
        a_blk = _chol.solve_lower(Lkk, r_blk)
        blocks.append(a_blk)
        # the residual of the rows below the panel
        below = (local_rows >= c + B)[:, None]
        upd = _mm(L_loc[:, c:c + B], pvary(a_blk, ax))
        r_loc = r_loc - torch.where(below, upd, torch.zeros_like(upd))
    a = torch.cat(blocks)
    return a[:, 0] if vec else a


def distributed_solve_lower(mesh, L, b, block_size=128, axis_name="rows"):
    """Solve L a = b with L row-sharded and b row-sharded the same way (this
    rank's rows of b: (N/P,) or (N/P, K)); returns `a` whole on every rank."""
    ax = Axis(mesh, axis_name)
    return _fwd_solve_loop(L, b, block_size, ax, L.shape[1])


def _bwd_solve_loop(L_loc, b, B, ax, n_total):
    """Solve Lᵀ a = b (L lower, rows sharded; b whole, (N,) or (N, K)).
    Blocked backward substitution from the last panel; each step's
    off-diagonal part is a local (B × n_loc) GEMM against the solved entries
    of this rank's rows, psum-reduced."""
    n_loc = L_loc.shape[0]
    dev = L_loc.device
    row_base = ax.rank * n_loc
    local_rows = row_base + torch.arange(n_loc, device=dev)
    vec = b.dim() == 1
    b2 = b[:, None] if vec else b
    a = torch.zeros_like(b2)
    for i in range(n_total // B):
        c = (n_total // B - 1 - i) * B
        Lkk = _assemble_diag_block(L_loc, c, B, row_base, ax)
        below = (local_rows >= c + B)[:, None]
        panel = L_loc[:, c:c + B]
        a_loc = pvary(a, ax)[row_base:row_base + n_loc]
        contrib = psum(_mm(torch.where(below, panel, torch.zeros_like(panel)).T, a_loc), ax)
        a_blk = _chol.solve_lower(Lkk, b2[c:c + B] - contrib, trans=True)
        a = torch.cat([a[:c], a_blk, a[c + B:]])
    return a[:, 0] if vec else a


def distributed_solve_upper_T(mesh, L, b, block_size=128, axis_name="rows"):
    """Solve Lᵀ a = b with L row-sharded and b whole ((N,) or (N, K));
    returns `a` whole.  With `distributed_solve_lower` this gives the
    (L Lᵀ)⁻¹ the posterior path needs."""
    ax = Axis(mesh, axis_name)
    return _bwd_solve_loop(L, b, block_size, ax, L.shape[1])


def distributed_chol_solve(mesh, L, b, block_size=128, axis_name="rows"):
    """(L Lᵀ)⁻¹ b with L and b row-sharded; returns the solution whole."""
    z = distributed_solve_lower(mesh, L, b, block_size=block_size, axis_name=axis_name)
    return distributed_solve_upper_T(mesh, L, z, block_size=block_size, axis_name=axis_name)


def distributed_logdet_chol(mesh, L, axis_name="rows"):
    """log det(L Lᵀ) for a row-sharded lower factor."""
    ax = Axis(mesh, axis_name)
    n_loc = L.shape[0]
    rows = torch.arange(n_loc, device=L.device)
    d = L[rows, ax.rank * n_loc + rows]
    return psum(2.0 * torch.sum(torch.log(d)), ax)


def distributed_lower_matvec(mesh, L, v, axis_name="rows"):
    """y = L v for a row-sharded L and a whole v ((N,) or (N, K)); returns
    this rank's rows of y (the distributed `rand` building block)."""
    return _mm(L, pvary(v, Axis(mesh, axis_name)))


# --------------------------------------------------------------------------
# Block-cyclic row layout.  The contiguous slab costs N³/(2P) MACs per rank:
# as the factorisation proceeds the low ranks' rows finish, but every rank
# runs the same full-slab GEMMs.  Dealing B-row blocks round robin (global
# block g on rank g mod P) keeps every rank's active rows within one block
# of (N − c)/P at every panel: ≈ N³/(3P) MACs.  For panel k the local slots
# strictly below it are [t(k), N/(BP)) with t(k) = ⌊(k + 1)/P⌋, the same on
# every rank up to one masked boundary block, and slot ⌊k/P⌋ (the one
# holding block k on its owner k mod P) is the first row of the trailing
# matrix.  The gathered panel goes back to natural row order by a fixed
# permutation (O(N·B) data movement per panel).
# --------------------------------------------------------------------------


def _cyclic_perm(nb, p):
    """Global block order that makes the cyclic layout contiguous per rank
    (rank d's slots hold global blocks [d, d+P, d+2P, …])."""
    return np.arange(nb).reshape(-1, p).T.reshape(-1)


def _relayout_local(x_loc, B, ax, to_cyc):
    """The contiguous ↔ cyclic row-block relayout of this rank's slab: a
    padded `all_to_all`.  Each rank owns m = n_loc/B row blocks and sends
    each to its new owner (at most q = ⌈m/P⌉ per destination), so each
    rank's traffic is one slab, never the whole matrix."""
    p, rank = ax.size, ax.rank
    n_loc = x_loc.shape[0]
    rest = tuple(x_loc.shape[1:])
    m = n_loc // B
    q = -(-m // p)
    blocks = x_loc.reshape((m, B) + rest)
    slot_of = {}
    for j in range(m):
        if to_cyc:
            g = rank * m + j  # global block id (contiguous source)
            r, i = g % p, j // p
        else:
            g = rank + j * p  # global block id (cyclic source, slot j)
            r = g // m
            i = (g - r * m) // p
        slot_of[r * q + i] = j
    zero = torch.zeros((B,) + rest, dtype=x_loc.dtype, device=x_loc.device)
    send = torch.stack([blocks[slot_of[s]] if s in slot_of else zero for s in range(p * q)])
    recv = all_to_all(send.reshape((p, q, B) + rest), ax)  # recv[s] = s's sends to me
    flat = recv.reshape((p * q, B) + rest)
    ts = np.arange(m)
    if to_cyc:
        g = rank + ts * p  # my cyclic slots' global block ids
        d, i = g // m, (g % m) // p
    else:
        g = rank * m + ts  # my contiguous blocks' global ids
        d, i = g % p, ts // p
    idx = torch.as_tensor(d * q + i, device=x_loc.device)
    return flat[idx].reshape((n_loc,) + rest)


def _relayout(mesh, K, block_size, axis_name, to_cyc):
    ax = Axis(mesh, axis_name)
    if ax.size == 1:
        return K
    return _relayout_local(K, block_size, ax, to_cyc)


def to_cyclic(mesh, K, block_size, axis_name="rows"):
    """This rank's slab of a contiguously row-sharded (N, …) array,
    re-dealt into the block-cyclic row layout."""
    return _relayout(mesh, K, block_size, axis_name, to_cyc=True)


def from_cyclic(mesh, K, block_size, axis_name="rows"):
    """Inverse of `to_cyclic`."""
    return _relayout(mesh, K, block_size, axis_name, to_cyc=False)


def _chol_cyclic_loop(K_loc, B, ax, n_total):
    """Panel factorisation of the cyclic-layout local slab: local slot t on
    rank r holds global row block r + t·P."""
    p, rank = ax.size, ax.rank
    n_loc = K_loc.shape[0]
    dev = K_loc.device
    nb, nbl = n_total // B, n_loc // B
    slots = torch.arange(n_loc, device=dev) // B
    g_rows = (rank + slots * p) * B + torch.arange(n_loc, device=dev) % B
    trailing = K_loc  # rows from slot ⌊k/P⌋, columns from c
    pieces = []  # (first slot, finished column panel from that slot down)
    for k in range(nb):
        c = k * B
        owner, s = k % p, k // p
        t0 = (k + 1) // p  # first slot strictly below the panel (= ⌊(k+1)/P⌋)
        is_owner = _flag(rank == owner, dev)
        # -- the diagonal block: the owner's slot s, psum-broadcast -----------
        contrib = trailing[:B, :B]
        diag = psum(torch.where(is_owner, contrib, torch.zeros_like(contrib)), ax)
        L_kk = pvary(_chol.cholesky_psd(diag), ax)
        col = torch.cat([torch.where(is_owner, L_kk, contrib), trailing[B:, :B]])
        if t0 >= nbl:  # no slot of this rank lies below the panel
            pieces.append((s, col))
            continue
        # -- the active slots: solve the panel rows below ----------------------
        off = (t0 - s) * B
        A_act = col[off:]
        below = (g_rows[t0 * B:] >= c + B)[:, None]  # ≤ one masked boundary block
        P_act = _chol.solve_lower(L_kk, A_act.T).T
        new_act = torch.where(below, P_act, torch.zeros_like(P_act))
        pieces.append((s, torch.cat([col[:off], torch.where(below, P_act, A_act)])))
        if c + B >= n_total:
            continue
        # -- gather the panel and restore natural row order ---------------------
        m_loc = n_loc - t0 * B
        flat = all_gather(new_act, ax)  # (P·m_loc, B)
        gr = np.arange(c + B, n_total)
        gb = gr // B
        idx = (gb % p) * m_loc + (gb // p - t0) * B + gr % B
        trail = pvary(flat[torch.as_tensor(idx, device=dev)], ax)  # (N - c - B, B)
        # -- trailing update on the active rows only ------------------------------
        trailing = trailing[off:, B:] - _mm(new_act, trail.T)
    cols = torch.arange(B, device=dev)
    out = []
    for k, (s, piece) in enumerate(pieces):
        # zero the strict upper triangle (global coordinates) panel by panel
        keep = (k * B + cols)[None, :] <= g_rows[s * B:, None]
        piece = torch.where(keep, piece, torch.zeros_like(piece))
        if s:
            piece = torch.cat([piece.new_zeros((s * B, B)), piece])
        out.append(piece)
    return torch.cat(out, dim=1)


def distributed_cholesky_cyclic(mesh, K, block_size=128, axis_name="rows"):
    """Lower Cholesky factor of a PSD matrix whose rows are sharded over
    `axis_name`, factored in the block-cyclic row layout (≈ N³/(3P) MACs a
    rank against N³/(2P) for `distributed_cholesky`).  Takes and returns
    the contiguous row slabs; the relayout is internal (two padded
    all-to-alls of one slab each)."""
    ax = Axis(mesh, axis_name)
    n = K.shape[1]
    p = ax.size
    _local_slab(n, p)
    nb = n // block_size
    if n % block_size != 0 or nb % p != 0:
        raise ValueError(
            f"N={n} needs block_size | N and P | (N/block_size) "
            f"(got block_size={block_size}, P={p})")
    Kc = to_cyclic(mesh, K, block_size, axis_name=axis_name)
    Lc = _chol_cyclic_loop(Kc, block_size, ax, n)
    return from_cyclic(mesh, Lc, block_size, axis_name=axis_name)


def cyclic_compatible(n, p, block_size):
    """True iff block_size | N and P | (N/block_size)."""
    return n % block_size == 0 and (n // block_size) % p == 0


def _pick_cyclic_block(n, p, block_size):
    """Shrink the panel width toward m = n/(p·B) ≥ p row blocks per rank,
    so the relayout's padded all_to_all stays near one slab per direction,
    but never past 32-wide panels and never beyond 48 panels (the panel
    loop is unrolled).  The reference's choice, so both packages factor in
    the same order."""
    B = block_size
    while B > 32:
        half = B // 2
        if (n // p) // B >= p:
            break
        if not cyclic_compatible(n, p, half) or n // half > 48:
            break
        B = half
    return B


def distributed_cholesky_auto(mesh, K, block_size=128, axis_name="rows"):
    """The default distributed factorisation: the block-cyclic variant
    whenever divisibility allows, the contiguous slab otherwise.  The same
    contiguous row slabs in and out either way."""
    n = K.shape[1]
    p = Axis(mesh, axis_name).size
    if cyclic_compatible(n, p, block_size):
        return distributed_cholesky_cyclic(
            mesh, K, block_size=_pick_cyclic_block(n, p, block_size), axis_name=axis_name)
    return distributed_cholesky(mesh, K, block_size=block_size, axis_name=axis_name)


def distributed_mvn_logpdf(mesh, K, mean, y, block_size=128, axis_name="rows"):
    """log N(y; mean, K) with K's rows sharded over `axis_name`: `K` is this
    rank's slab, `mean` and `y` this rank's rows.  One distributed Cholesky
    (cyclic when divisibility allows), one distributed forward solve and a
    psum'd logdet."""
    n = K.shape[1]
    L = distributed_cholesky_auto(mesh, K, block_size=block_size, axis_name=axis_name)
    alpha = distributed_solve_lower(mesh, L, y - mean, block_size=block_size, axis_name=axis_name)
    logdet = distributed_logdet_chol(mesh, L, axis_name=axis_name)
    quad = torch.sum(alpha * alpha)
    return -0.5 * (n * math.log(2.0 * math.pi) + logdet + quad)

"""Blocked left-looking Cholesky and blocked triangular solves with
closed-form reverse rules (counterpart of `stheno_tpu/ops/blocked_cholesky.py`).

The factorisation runs almost all of its flops in large GEMMs:

- panels of `block` columns (default 1024); each step's update
  `A[c:, c:c+B] −= L[c:, :c] @ L[c:c+B, :c]ᵀ` is one `torch.matmul` per
  earlier panel (`_left_update`), not one over all of them;
- the diagonal B×B block recurses on the same routine down to `base`
  (default 256), where the base-case factoriser (kernel 2,
  `cuda.chol_block.chol_block`, unless scoped otherwise) factors it;
- the panel TRSM `L21 = A21 L11⁻ᵀ` is a GEMM against the explicit blocked
  triangular inverse, whose diagonal base blocks the base-case inverse
  (kernel 3, `cuda.chol_block.tri_inv_block`) inverts in one batched launch.

`_BlockedCholesky` is a `torch.autograd.Function`.  Its backward dispatches
on the scoped `config.bwd_params` in force at the forward call: the
iterative panel sweep (`_chol_bwd_iter`, the default), the recursive
two-way split (`_chol_bwd_rec`) or the fused sweep (`_chol_bwd_fused`),
reusing the forward's saved panel inverses where the backward can.
`via_inv` picks how the backward's solves apply diagonal blocks: GEMMs
against explicit inverses (default) or `torch.linalg.solve_triangular`.  The
blocked solves carry their closed-form adjoints (`_SolveLower`,
`_SolveUpperT`).  Ragged N is identity-padded to the next panel multiple
outside the Functions.  `sym=True` factors 0.5·(A + Aᵀ) with the fold done
in each panel's read; `blocked_lauum` forms Mᵀ M of a lower-triangular M.

Base cases: the raw scoped keys `base_cholesky` and `base_tri_inv`
(`config.scoped(base_cholesky=fn)`) swap the factoriser and the inverse of
the base blocks; `torch_chol_lower` and `torch_tri_inv_lower` are the
library versions.  The port's defaults are kernels 2 and 3 for f32, and
the library versions for any other dtype (`default_bases`).  The
reference's defaults are XLA's built-ins, with its Pallas kernels as the
swap-in (reference `blocked_cholesky.py:81-130`).  The deprecated setters
`set_base_cholesky`, `set_base_tri_inv`, `set_bwd_params`,
`set_gemm_precision` and `set_bwd_precision` move the module defaults
under the scopes, as in the reference.

Numerics: the GEMMs go through `_mm`, at the scoped `config.gemm_precision`
(the reverse rule at `config.bwd_precision` where one is scoped).  The
port's default is 'highest', full fp32 with TF32 off, where `_mm` is
exactly `a @ b`; 'high' is 3xTF32 (the split kernel,
`cuda/tf32_split.py`, then three TF32 products), 'default' one TF32
product.  f64 operands ignore the setting.  On the TPU, low-precision
GEMMs inside the left-looking accumulation made the late diagonal blocks
indefinite (NaN at N=16k) and a low-precision backward gave gradients 56×
wrong (reference `blocked_cholesky.py:28-37`, `:626-632`); see
`PERF.md` §6 for what the card reads.  TF32 is switched on only around
the products of a CUDA `_mm` below 'highest'.

The update sums its inner dimension panel by panel (at most `block` terms
in one GEMM, then one f32 add per earlier panel), as a right-looking
factor does.  One GEMM over all c earlier columns (the reference's order,
`blocked_cholesky.py:193-197`) adds up to N − B products in one running
f32 sum: on an H100 at N = 16384 that left the factor's backward error
‖LLᵀ − A‖/‖A‖ at 2.5e-6 against cuSOLVER's 6.8e-7, and the
gradient-enhanced GP's f″ posterior mean 4× further from f64 than
cuSOLVER's (`stheno_tpu_torch/accuracy_probe.py`).

The factor depends on tril(A) only: panels read lower column slabs and the
base kernel ignores block-upper content (reference `blocked_cholesky.py:73-78`).
The reference's other TRSMs (the backward base case, the solves' diagonal
blocks) are `torch.linalg.solve_triangular`.

Tracing (`utils/logging.py`): while a span is open, `_mm` credits it with
2·m·n·k (`gemm_flops`, the logical work at any precision), and the factor
and the two reverse sweeps with each panel (`panels`).  The reverse rules of
the factor and of the solves are `chol.reverse` and `solve.reverse` spans,
children of the span the forward ran in.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from itertools import zip_longest

import torch

from stheno_tpu_torch import config as _cfg
from stheno_tpu_torch.config import Precision
from stheno_tpu_torch.cuda.chol_block import chol_block, tri_inv_block
from stheno_tpu_torch.cuda.tf32_split import tf32_round_plain, tf32_split
from stheno_tpu_torch.utils import logging as _trace

#: Default GEMM precision.  A kept divergence: the reference's is HIGH
#: (bf16_3x), tuned against the TPU's MXU; the port stays at full fp32
#: until a decision on the card's readings (`PERF.md` §6, `ROADMAP.md` §A)
#: says otherwise, so that no path's arithmetic moves with this module.
_PREC = Precision.HIGHEST

#: Optional precision of the Cholesky reverse rule alone (None: follow the
#: forward's).  The reference measured 'default' there 56× wrong on its
#: TPU (reference `blocked_cholesky.py:626-632`).
_BWD_PREC = None


def set_gemm_precision(p):
    """Set the module default GEMM precision ('default' | 'high' |
    'highest' or a `Precision`); returns the previous one.  None raises: a
    forward precision is always required.  DEPRECATED: prefer the scoped
    ``with stheno_tpu_torch.config.gemm_precision(p): ...``, which cannot
    leak."""
    global _PREC
    if p is None:
        raise ValueError(
            "set_gemm_precision(None) is invalid (a forward precision is always required); use "
            "set_bwd_precision(None) to make the backward follow the forward")
    prev = _PREC
    _PREC = _cfg._norm_precision(p)
    return prev


def set_bwd_precision(p):
    """Set the module default precision of the Cholesky reverse rule (None:
    follow the forward); returns the previous one.  DEPRECATED: prefer the
    scoped ``with stheno_tpu_torch.config.bwd_precision(p): ...``."""
    global _BWD_PREC
    prev = _BWD_PREC
    _BWD_PREC = None if p is None else _cfg._norm_precision(p)
    return prev


def _active_prec():
    return _cfg.active_override("gemm_precision", _PREC)


def _active_bwd_prec():
    return _cfg.active_override("bwd_precision", _BWD_PREC)


@contextmanager
def _tf32(on=True):
    """TF32 tensor-core products for the block (or, with `on=False`, none).
    The flag is process-wide (the port drives the card from one Python
    thread); it is restored on any exit.  Only the legacy switch is used,
    the one every reader in the port checks: newer PyTorch refuses a mix of
    it and `fp32_precision`."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _add_product(out, a, b):
    """out += a @ b, the sum folded into the GEMM where it can be."""
    if out.dim() == 2 and a.dim() == 2 and b.dim() == 2:
        return out.addmm_(a, b)
    if out.dim() == 3 and a.dim() == 3 and b.dim() == 3:
        return out.baddbmm_(a, b)
    return out.add_(a @ b)


def _products(a, b, prec):
    """a @ b of f32 operands below 'highest' (module note).  On the card:
    'default' is one TF32 product; 'high' splits each operand once (the
    split kernel) and adds (hi_a lo_b + lo_a hi_b) + hi_a hi_b, small
    terms first, the last product in inner-dimension chunks of at most
    256.  On the CPU, which has no tensor cores and whose flags are left
    alone, the TF32 rounding is written out: 'default' multiplies the
    operands rounded to TF32 in fp32; 'high' multiplies the split parts in
    the same order and chunks, each lo rounded to TF32 once more as the
    tensor core would."""
    on_card = a.is_cuda
    if prec is Precision.DEFAULT:
        if on_card:
            with _tf32():
                return a @ b
        return tf32_round_plain(a) @ tf32_round_plain(b)
    ha, la = tf32_split(a)
    hb, lb = tf32_split(b)
    if not on_card:
        la, lb = tf32_round_plain(la), tf32_round_plain(lb)
    # The tensor cores' f32 accumulation truncates, so a product's error
    # grows with its inner dimension (biased, where fp32's round-to-nearest
    # errors cancel), and the factor adds these errors up panel by panel.
    # 256 is the chunk at which the flagship's gradient comes nearest
    # fp32's (`chip_smoke.py` phase 3's limit 5e-3): `accuracy_probe --part
    # chunks` on an H100 (700 W) read its v1 4.6e-3 of itself at 1024 (the
    # gradient-enhanced noise gradient 3.2e-2 of the largest at seed 0),
    # 2.3e-3 at 256 (1.5e-2), 1.2e-2 at 128 and 9.2e-3 at 64 (6.8e-4).  No
    # chunk holds both paths at every seed (PERF.md §6).  The small terms
    # are one product each: their error is 2⁻¹¹ smaller.
    chunk, k = 256, a.shape[-1]
    with _tf32() if on_card else nullcontext():
        out = ha @ lb
        _add_product(out, la, hb)
        for j in range(0, k, chunk):
            _add_product(out, ha[..., j : j + chunk], hb[..., j : j + chunk, :])
    return out


class _LowPrecisionMatmul(torch.autograd.Function):
    """a @ b below 'highest'.  The backward is the two products at the
    precision of the forward (as XLA differentiates a dot at its
    precision), through this Function again, so a second derivative
    sees them too.  No `vmap` rule: a vmapped factor takes `torch.linalg`
    (`ops/chol.py:_use_blocked`) and never reaches here."""

    @staticmethod
    def forward(a, b, prec):
        return _products(a, b, prec)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, prec = inputs
        ctx.prec = prec
        ctx.save_for_backward(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = _LowPrecisionMatmul.apply(g, b.mT, ctx.prec) if ctx.needs_input_grad[0] else None
        gb = _LowPrecisionMatmul.apply(a.mT, g, ctx.prec) if ctx.needs_input_grad[1] else None
        return ga, gb, None


def _gemm_flops(a, b):
    """2·m·n·k of a @ b, times the broadcast batch (from the shapes alone:
    `torch.broadcast_shapes` makes tensors, which costs the host tens of µs)."""
    sa, sb = a.shape, b.shape
    flops = 2 * sa[-1] * (sb[-1] if len(sb) > 1 else 1) * (sa[-2] if len(sa) > 1 else 1)
    for x, y in zip_longest(reversed(sa[:-2]), reversed(sb[:-2]), fillvalue=1):
        flops *= max(x, y)
    return flops


def _mm(a, b):
    """a @ b at the active GEMM precision.  At 'highest', and for any
    operand that is not f32, exactly `a @ b`.  Below it the operands are
    matrices or equal-shaped batches of them; a vector `b` is taken as a
    column."""
    if _trace.active:
        _trace.credit("gemm_flops", _gemm_flops(a, b))
    prec = _active_prec()
    if prec is Precision.HIGHEST or a.dtype != torch.float32 or b.dtype != torch.float32:
        return a @ b
    if b.dim() == 1:
        return _mm_below(a, b[:, None], prec)[..., 0]
    return _mm_below(a, b, prec)


def _mm_below(a, b, prec):
    """a @ b of f32 matrices (or equal batches) below 'highest'."""
    if a.dim() != b.dim() or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"_mm below 'highest' takes matrices or equal batches, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _LowPrecisionMatmul.apply(a, b, prec)
    # inside the reverse rules and the Functions' forwards: no graph to keep
    return _products(a, b, prec)


#: Backward defaults (reference `blocked_cholesky.py:359-365`): recursion
#: base of the reverse rule, whether its solves go through explicit
#: inverses, its algorithm, and the panel width of its sweeps.
_BWD_BASE = 256
_BWD_VIA_INV = True
_BWD_MODE = "iter"
_BWD_BLOCK = 4096


def set_bwd_params(base=None, via_inv=None, mode=None, block=None):
    """Set the module defaults of the reverse rule's knobs (only the ones
    given); returns the previous (base, via_inv, mode, block).  DEPRECATED:
    prefer the scoped ``with stheno_tpu_torch.config.bwd_params(...): ...``."""
    global _BWD_BASE, _BWD_VIA_INV, _BWD_MODE, _BWD_BLOCK
    if mode is not None and mode not in _cfg.BWD_MODES:
        raise ValueError(f"unknown backward mode {mode!r}; expected one of {_cfg.BWD_MODES}")
    prev = (_BWD_BASE, _BWD_VIA_INV, _BWD_MODE, _BWD_BLOCK)
    if base is not None:
        _BWD_BASE = base
    if via_inv is not None:
        _BWD_VIA_INV = via_inv
    if mode is not None:
        _BWD_MODE = mode
    if block is not None:
        _BWD_BLOCK = block
    return prev


def _active_bwd_params():
    """(base, via_inv, mode, block) of the backward, with scoped overrides
    applied."""
    return (
        _cfg.active_override("bwd_base", _BWD_BASE),
        _cfg.active_override("bwd_via_inv", _BWD_VIA_INV),
        _cfg.active_override("bwd_mode", _BWD_MODE),
        _cfg.active_override("bwd_block", _BWD_BLOCK),
    )


def torch_chol_lower(A):
    """`torch.linalg.cholesky` of the matrix whose lower triangle is
    tril(A): the library base case, and the ragged fallback (it reads one
    triangle, as the blocked path does)."""
    return torch.linalg.cholesky(torch.tril(A) + torch.tril(A, -1).mT)


def torch_tri_inv_lower(L):
    """Inverse of lower-triangular L ((n, n) or (batch, n, n)) by
    `torch.linalg.solve_triangular` against I: the library base case."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def default_bases(dtype):
    """The base cases a matrix of `dtype` takes when none is scoped in:
    kernels 2 and 3 for f32, which is all they take; the library versions
    for any other dtype.  The choice is made here, by dtype, before any
    launch: the kernels still raise on f64 when called directly."""
    if dtype == torch.float32:
        return chol_block, tri_inv_block
    return torch_chol_lower, torch_tri_inv_lower


#: Module defaults of the base cases; None takes `default_bases` by dtype.
_BASE_CHOL = None
_BASE_TRI_INV = None


def set_base_cholesky(fn):
    """Set the module default base-case factoriser (None: by dtype); returns
    the previous one.  DEPRECATED: prefer the scoped
    ``with stheno_tpu_torch.config.scoped(base_cholesky=fn): ...``."""
    global _BASE_CHOL
    prev, _BASE_CHOL = _BASE_CHOL, fn
    return prev


def set_base_tri_inv(fn):
    """Set the module default base-case triangular inverse (None: by dtype);
    returns the previous one.  DEPRECATED: prefer the scoped
    ``with stheno_tpu_torch.config.scoped(base_tri_inv=fn): ...``."""
    global _BASE_TRI_INV
    prev, _BASE_TRI_INV = _BASE_TRI_INV, fn
    return prev


def _base_chol(A):
    fn = _cfg.active_override("base_cholesky", _BASE_CHOL)
    return (fn or default_bases(A.dtype)[0])(A)


def _active_base_tri_inv(dtype):
    return _cfg.active_override("base_tri_inv", _BASE_TRI_INV) or default_bases(dtype)[1]


def _base_tri_inv(L):
    return _active_base_tri_inv(L.dtype)(L)


def _diag_blocks(L, bs):
    """(nb, bs, bs) stack of the aligned diagonal blocks of L (n = nb·bs)."""
    nb = L.shape[-1] // bs
    return L.reshape(nb, bs, nb, bs).diagonal(dim1=0, dim2=2).permute(2, 0, 1)


def _tri_inv_lower_batched(L, bs):
    """Bottom-up batched L⁻¹ for n = 2^k·bs: ONE base-case call (one
    kernel-3 launch by default) inverts every diagonal base block, then
    log2(n/bs) rounds of batched GEMMs assemble the pairwise combines

        inv([[A, 0], [B, C]]) = [[A⁻¹, 0], [−C⁻¹ B A⁻¹, C⁻¹]]."""
    n = L.shape[-1]
    invs = _base_tri_inv(_diag_blocks(L, bs).contiguous())
    s = bs
    while s < n:
        m = n // (2 * s)
        Bs = _diag_blocks(L, 2 * s)[:, s:, :s]
        A = invs[0::2]
        C = invs[1::2]
        out = torch.zeros((m, 2 * s, 2 * s), dtype=L.dtype, device=L.device)
        out[:, :s, :s] = A
        out[:, s:, :s] = -_mm(C, _mm(Bs, A))
        out[:, s:, s:] = C
        invs = out
        s *= 2
    return invs[0]


def blocked_tri_inv_lower(L, base):
    """Explicit inverse of a lower-triangular matrix.  Power-of-2 multiples
    of `base` take the batched bottom-up construction; other sizes split in
    two recursively.  The base blocks go to the active base-case inverse
    (the reference leaves the batched path when a custom one is scoped in;
    here every base inverse takes a batch, so both keep it)."""
    n = L.shape[-1]
    if n <= base:
        return _base_tri_inv(L)
    nb = n // base
    if n % base == 0 and nb & (nb - 1) == 0:
        return _tri_inv_lower_batched(L, base)
    h = ((n // 2) // 64) * 64
    if h == 0:
        return _base_tri_inv(L)
    Ai = blocked_tri_inv_lower(L[:h, :h], base=base)
    Ci = blocked_tri_inv_lower(L[h:, h:], base=base)
    out = torch.zeros_like(L)
    out[:h, :h] = Ai
    out[h:, :h] = -_mm(Ci, _mm(L[h:, :h], Ai))
    out[h:, h:] = Ci
    return out


def _left_update(A_panel, L_rows, L_panel, B):
    """A_panel − L_rows @ L_panelᵀ with the inner dimension (the c columns
    factored so far) summed B at a time, so no running f32 sum in a GEMM
    takes more than B products (see the module note)."""
    for j in range(0, L_rows.shape[-1], B):
        A_panel = A_panel - _mm(L_rows[:, j : j + B], L_panel[:, j : j + B].T)
    return A_panel


def _blocked_cholesky_impl(A, block=1024, base=256, sym=False, collect_invs=False):
    """Left-looking blocked factor of tril(A), or of 0.5·(A + Aᵀ) with
    `sym` (each panel folds in its mirrored slab, so the symmetric matrix
    is never formed).  With `collect_invs` (top level only) also returns
    the (nb, B, B) stack of the panels' diagonal-block inverses, the last
    panel's included, for the backward to reuse."""
    n = A.shape[-1]
    if n <= base:
        L = _base_chol(0.5 * (A + A.mT) if sym else A)
        return (L, None) if collect_invs else L
    # panel width: ≤ n/2, so the recursion strictly shrinks; a multiple of 64
    B = (min(block, n // 2) // 64) * 64
    if B == 0 or n % B != 0:
        L = torch_chol_lower(0.5 * (A + A.mT) if sym else A)
        return (L, None) if collect_invs else L

    nb = n // B
    L = torch.zeros_like(A)
    invs = []
    for kb in range(nb):
        if _trace.active:
            _trace.credit("panels", 1)
        c = kb * B
        A_panel = A[c:, c : c + B]
        if sym:
            A_panel = 0.5 * (A_panel + A[c : c + B, c:].T)
        if kb > 0:
            A_panel = _left_update(A_panel, L[c:, :c], L[c : c + B, :c], B)
        L11 = _blocked_cholesky_impl(A_panel[:B], block=max(base, B // 4), base=base)
        L[c : c + B, c : c + B] = L11
        if n - c > B or collect_invs:
            L11inv = blocked_tri_inv_lower(L11, base=base)
        if n - c > B:
            L[c + B :, c : c + B] = _mm(A_panel[B:], L11inv.T)
        if collect_invs:
            invs.append(L11inv)
    if collect_invs:
        return L, torch.stack(invs)
    return L


def _phi(M):
    """Lower triangle with halved diagonal (the Cholesky-pullback projector)."""
    out = torch.tril(M)
    out.diagonal().mul_(0.5)
    return out


def _chol_bwd_base(L, L_bar):
    """Closed-form small-block reverse rule L⁻ᵀ Φ(Lᵀ tril(L̄)) L⁻¹ (raw,
    lower convention) via two TRSMs."""
    P = _phi(_mm(L.T, torch.tril(L_bar)))
    W = torch.linalg.solve_triangular(L.T, P, upper=True)  # L⁻ᵀ P
    return torch.linalg.solve_triangular(L, W, upper=False, left=False)  # W L⁻¹


def _inv_block(invs, g, s):
    """The saved inverse of the diagonal block [g, g+s) of the factor: an
    aligned diagonal sub-block of a panel inverse is the inverse of the
    matching sub-block of L."""
    Bf = invs.shape[-1]
    r = g % Bf
    return invs[g // Bf][r : r + s, r : r + s]


def _reuse_ok(invs, bs, g0):
    return invs is not None and bs <= invs.shape[-1] and invs.shape[-1] % bs == 0 and g0 % bs == 0


def _solve_upper_T_reuse(L11, b, bs, invs, c_global):
    """Blocked backward substitution L11ᵀ x = b whose diagonal blocks are
    GEMMs against the forward's saved inverses (L11 sits at global offset
    `c_global` of the factor)."""
    n = L11.shape[-1]
    nb = n // bs
    x = torch.empty_like(b)
    for kb in reversed(range(nb)):
        cc = kb * bs
        rhs = b[cc : cc + bs]
        if kb < nb - 1:
            rhs = rhs - _mm(L11[cc + bs :, cc : cc + bs].T, x[cc + bs :])
        x[cc : cc + bs] = _mm(_inv_block(invs, c_global + cc, bs).T, rhs)
    return x


def _right_solve(L11, Lb, bs, via_inv, invs, c):
    """Lb L11⁻¹ (the raw cotangent of K21 from that of L21 = K21 L11⁻ᵀ) by
    blocked substitution: against the forward's saved inverses where they
    align and `via_inv` holds, else through `_solve_upper_T_impl`."""
    if via_inv and _reuse_ok(invs, bs, c) and L11.shape[-1] % bs == 0:
        return _solve_upper_T_reuse(L11, Lb.T, bs, invs, c).T
    return _padded(_solve_upper_T_impl, L11, Lb.T, bs, via_inv).T


def _chol_bwd_rec(L, L_bar, base, via_inv=True, invs=None, g0=0):
    """Recursive blocked reverse rule (raw lower convention), reversing
        L11 = chol(K11);  L21 = K21 L11⁻ᵀ;  L22 = chol(K22 − L21 L21ᵀ)."""
    n = L.shape[-1]
    h = ((n // 2) // 64) * 64
    if n <= base or h == 0:
        return _chol_bwd_base(L, L_bar)
    L11, L21, L22 = L[:h, :h], L[h:, :h], L[h:, h:]
    Lb11, Lb21, Lb22 = L_bar[:h, :h], L_bar[h:, :h], L_bar[h:, h:]

    S22 = _chol_bwd_rec(L22, Lb22, base, via_inv, invs, g0 + h)
    Lb21_eff = Lb21 - _mm(S22 + S22.T, L21)
    K21_bar = _right_solve(L11, Lb21_eff, max(base, h // 4), via_inv, invs, g0)
    Lb11_eff = Lb11 - _mm(K21_bar.T, L21)
    S11 = _chol_bwd_rec(L11, Lb11_eff, base, via_inv, invs, g0)

    out = torch.zeros_like(L)
    out[:h, :h] = S11
    out[h:, :h] = K21_bar
    out[h:, h:] = S22
    return out


def _sweep_block(n, block):
    """Panel width of a reverse sweep, or None when the sweep would have a
    single or a ragged panel (the sweeps then defer to the recursive rule)."""
    B = (min(block, n) // 64) * 64
    return None if B == 0 or n % B != 0 or n <= B else B


def _chol_bwd_iter(L, L_bar, block, base, via_inv=True, invs=None):
    """Iterative panel-sweep reverse rule; returns the SYMMETRIC gradient.

    Reverses the factorisation panel by panel, last to first, keeping the
    symmetric gradient of the trailing Schur complement.  The reference
    grows it by concatenation only to dodge an XLA aliasing problem
    (`blocked_cholesky.py:510-516`); here every panel writes its rows and
    columns into one preallocated N×N buffer, and the trailing block is read
    back as a view.  Per panel the dominant op is one GEMM
    L̄21 −= 2·S22 @ L21 (m×m @ m×B)."""
    n = L.shape[-1]
    B = _sweep_block(n, block)
    if B is None:
        K_raw = _chol_bwd_rec(L, L_bar, base, via_inv, invs, 0)
        return 0.5 * (K_raw + K_raw.T)
    S = torch.empty_like(L)
    for kb in reversed(range(n // B)):
        if _trace.active:
            _trace.credit("panels", 1)
        c = kb * B
        e = c + B
        L11 = L[c:e, c:e]
        Lb11 = L_bar[c:e, c:e]
        if e < n:
            L21 = L[e:, c:e]
            # reverse of the Schur update K22 ← K22 − L21 L21ᵀ
            Lb21_eff = L_bar[e:, c:e] - 2.0 * _mm(S[e:, e:], L21)
            # reverse of L21 = K21 L11⁻ᵀ: K̄21 = L̄21 L11⁻¹ (raw convention)
            A21_bar = _right_solve(L11, Lb21_eff, max(base, B // 4), via_inv, invs, c)
            Lb11 = Lb11 - _mm(A21_bar.T, L21)
            # the symmetric convention halves the off-diagonal raw gradient
            S[e:, c:e] = 0.5 * A21_bar
            S[c:e, e:] = 0.5 * A21_bar.T
        S11_raw = _chol_bwd_rec(L11, Lb11, base, via_inv, invs, c)
        S[c:e, c:e] = 0.5 * (S11_raw + S11_raw.T)
    return S


def _chol_bwd_fused(L, L_bar, block, base, via_inv=True, invs=None):
    """Fused panel-sweep reverse rule (reference `blocked_cholesky.py:556-623`);
    returns the SYMMETRIC gradient.

    The sweep of `_chol_bwd_iter` with its per-panel solve folded into GEMMs
    against the panel's explicit inverse L11⁻¹:

    1. with K̄21 = L̄21_eff L11⁻¹, L11ᵀ (K̄21ᵀ L21) = L̄21_effᵀ L21, so the
       L̄11 correction enters inside Φ: Φ(L11ᵀ tril(L̄11) − L̄21_effᵀ L21);
    2. the panel's closed form S11_raw = L11⁻ᵀ Φ(·) L11⁻¹ and the cotangent
       solve K̄21 = L̄21_eff L11⁻¹ share the right factor L11⁻¹, so one
       (B+m)×B @ B×B GEMM gives both.

    The inverse is the forward's saved one when the panels align, else it
    is rebuilt with `blocked_tri_inv_lower`."""
    n = L.shape[-1]
    B = _sweep_block(n, block)
    if B is None:
        K_raw = _chol_bwd_rec(L, L_bar, base, via_inv, invs, 0)
        return 0.5 * (K_raw + K_raw.T)
    S = torch.empty_like(L)
    for kb in reversed(range(n // B)):
        if _trace.active:
            _trace.credit("panels", 1)
        c = kb * B
        e = c + B
        L11 = L[c:e, c:e]
        if invs is not None and invs.shape[-1] == B:
            L11inv = invs[kb]
        else:
            L11inv = blocked_tri_inv_lower(L11, base=base)
        G = _mm(L11.T, torch.tril(L_bar[c:e, c:e]))
        if e < n:
            L21 = L[e:, c:e]
            Lb21_eff = L_bar[e:, c:e] - 2.0 * _mm(S[e:, e:], L21)
            G = G - _mm(Lb21_eff.T, L21)  # fusion 1
        W = _mm(L11inv.T, _phi(G))
        if e < n:
            ZG = _mm(torch.cat([W, Lb21_eff]), L11inv)  # fusion 2
            S11_raw, A21_bar = ZG[:B], ZG[B:]
            S[e:, c:e] = 0.5 * A21_bar
            S[c:e, e:] = 0.5 * A21_bar.T
        else:
            S11_raw = _mm(W, L11inv)
        S[c:e, c:e] = 0.5 * (S11_raw + S11_raw.T)
    return S


class _BlockedCholesky(torch.autograd.Function):
    """L = blocked_cholesky(tril(A)) (or of 0.5·(A + Aᵀ) with `sym`); the
    backward returns the symmetric gradient, which is also the exact
    pullback through the `sym` fold.  The backward parameters, the base
    inverse and the GEMM precisions in scope at the forward call are the
    ones the backward uses: it runs at `bwd_precision`, or at the forward's
    precision when that is None (reference `blocked_cholesky.py:656-689`)."""

    @staticmethod
    def forward(ctx, A, block, base, sym):
        bwd = _active_bwd_params()
        _, via_inv, mode, _ = bwd
        prec = _active_prec()
        bwd_prec = _active_bwd_prec()
        bwd_prec = prec if bwd_prec is None else bwd_prec
        # the inverse stack (nb·B² floats) is kept only where the backward
        # reads it: the via-inverse solves and the fused sweep.  Made at the
        # forward's precision, an f32 stack is not reused by a backward at
        # another one (which rebuilds what it needs at its own); any other
        # dtype ignores the precisions
        same = bwd_prec == prec or A.dtype != torch.float32
        if ctx.needs_input_grad[0] and (via_inv or mode == "fused") and same:
            L, invs = _blocked_cholesky_impl(A, block, base, sym, collect_invs=True)
        else:
            L, invs = _blocked_cholesky_impl(A, block, base, sym), None
        ctx.bwd_params = bwd
        ctx.bwd_prec = bwd_prec
        ctx.base_tri_inv = _active_base_tri_inv(A.dtype)
        ctx.span = _trace.current()
        ctx.save_for_backward(L, invs)
        return L

    @staticmethod
    def backward(ctx, L_bar):
        L, invs = ctx.saved_tensors
        base, via_inv, mode, block = ctx.bwd_params
        with (_trace.span("chol.reverse", ctx.span),
              _cfg.scoped(base_tri_inv=ctx.base_tri_inv, gemm_precision=ctx.bwd_prec)):
            if mode == "fused":
                out = _chol_bwd_fused(L, L_bar, block, base, via_inv, invs)
            elif mode == "iter":
                out = _chol_bwd_iter(L, L_bar, block, base, via_inv, invs)
            else:
                K_raw = _chol_bwd_rec(L, L_bar, base, via_inv, invs, 0)
                out = 0.5 * (K_raw + K_raw.T)
        return out, None, None, None


def blocked_cholesky(A, block=1024, base=256, sym=False):
    """Lower Cholesky factor of PSD `A` (N×N) from its lower triangle (or of
    0.5·(A + Aᵀ) with `sym=True`), with the blocked closed-form reverse
    rule."""
    return _BlockedCholesky.apply(A, block, base, sym)


def blocked_lauum(M, block=1024):
    """S = Mᵀ M for lower-triangular M with ~n³/6 multiply-adds (LAPACK
    LAUUM's job, reference `blocked_cholesky.py:706-731`): per panel J
    (c = J·B), one GEMM M[c:, :c+B]ᵀ @ M[c:, c:c+B] gives the block column
    S[:c+B, c:c+B]; its strict-upper part is mirrored into S[c:c+B, :c]."""
    n = M.shape[-1]
    B = min(block, n)
    if n % B != 0:
        return _mm(M.T, M)
    S = torch.empty_like(M)
    for J in range(n // B):
        c = J * B
        col = _mm(M[c:, : c + B].T, M[c:, c : c + B])  # (c+B, B)
        S[: c + B, c : c + B] = col
        S[c : c + B, :c] = col[:c].T
    return S


# ---------------------------------------------------------------------------
# Blocked triangular solves with closed-form adjoints
# ---------------------------------------------------------------------------
#   x = L⁻¹ b:   b̄ = L⁻ᵀ ḡ,  L̄ = −tril(b̄ xᵀ)
#   x = L⁻ᵀ b:   b̄ = L⁻¹ ḡ,  L̄ = −tril(x b̄ᵀ)


def _solve_lower_impl(L, b, block=1024):
    """Solve L x = b (b: (N,) or (N, K)) by blocked forward substitution."""
    n = L.shape[-1]
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    B = min(block, n)
    if n % B != 0:
        x = torch.linalg.solve_triangular(L, b, upper=False)
    else:
        x = torch.empty_like(b)
        for kb in range(n // B):
            c = kb * B
            rhs = b[c : c + B]
            if kb > 0:
                rhs = rhs - _mm(L[c : c + B, :c], x[:c])
            x[c : c + B] = torch.linalg.solve_triangular(L[c : c + B, c : c + B], rhs, upper=False)
    return x[:, 0] if vec else x


def _solve_upper_T_impl(L, b, block=1024, via_inv=False):
    """Solve Lᵀ x = b (L lower) by blocked backward substitution.
    `via_inv=True` (the reverse sweep's fallback) applies each diagonal
    block as a GEMM against its blocked triangular inverse instead of a
    TRSM."""
    n = L.shape[-1]
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    B = min(block, n)
    if n % B != 0:
        x = torch.linalg.solve_triangular(L.T, b, upper=True)
    else:
        x = torch.empty_like(b)
        for kb in reversed(range(n // B)):
            c = kb * B
            rhs = b[c : c + B]
            if c + B < n:
                rhs = rhs - _mm(L[c + B :, c : c + B].T, x[c + B :])
            Lkk = L[c : c + B, c : c + B]
            if via_inv:
                x[c : c + B] = _mm(blocked_tri_inv_lower(Lkk, base=256).T, rhs)
            else:
                x[c : c + B] = torch.linalg.solve_triangular(Lkk.T, rhs, upper=True)
    return x[:, 0] if vec else x


def _outer_tril_neg(u, v):
    """−tril(u vᵀ) for vectors or (N, K) matrices."""
    M = torch.outer(u, v) if u.dim() == 1 else _mm(u, v.T)
    return M.tril_().neg_()


class _SolveLower(torch.autograd.Function):
    """x = L⁻¹ b; the adjoint runs at the forward's GEMM precision."""

    @staticmethod
    def forward(ctx, L, b, block):
        x = _solve_lower_impl(L, b, block)
        ctx.block = block
        ctx.prec = _active_prec()
        ctx.span = _trace.current()
        ctx.save_for_backward(L, x)
        return x

    @staticmethod
    def backward(ctx, g):
        L, x = ctx.saved_tensors
        with _trace.span("solve.reverse", ctx.span), _cfg.scoped(gemm_precision=ctx.prec):
            bbar = _solve_upper_T_impl(L, g, ctx.block)
            Lbar = _outer_tril_neg(bbar, x) if ctx.needs_input_grad[0] else None
        return Lbar, bbar, None


class _SolveUpperT(torch.autograd.Function):
    """x = L⁻ᵀ b; the adjoint runs at the forward's GEMM precision."""

    @staticmethod
    def forward(ctx, L, b, block):
        x = _solve_upper_T_impl(L, b, block)
        ctx.block = block
        ctx.prec = _active_prec()
        ctx.span = _trace.current()
        ctx.save_for_backward(L, x)
        return x

    @staticmethod
    def backward(ctx, g):
        L, x = ctx.saved_tensors
        with _trace.span("solve.reverse", ctx.span), _cfg.scoped(gemm_precision=ctx.prec):
            bbar = _solve_lower_impl(L, g, ctx.block)
            Lbar = _outer_tril_neg(x, bbar) if ctx.needs_input_grad[0] else None
        return Lbar, bbar, None


# ---------------------------------------------------------------------------
# Ragged-N padding: chol([[A, 0], [0, I]]) = [[chol(A), 0], [0, I]] and
# [[L, 0], [0, I]] [x; xp] = [b; 0] give x = L⁻¹b, xp = 0.  The pad and slice
# sit outside the Functions, so autograd differentiates them natively and
# the reverse rules always see panel-divisible shapes.
# ---------------------------------------------------------------------------


def _padded_n(n, block):
    return -(-n // block) * block


def _pad_identity(A, np_):
    """[[A, 0], [0, I]] of size np_."""
    eye = torch.eye(np_ - A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.block_diag(A, eye)


def _pad_rows(b, np_):
    return torch.cat([b, b.new_zeros((np_ - b.shape[0], *b.shape[1:]))])


def _padded(solve, L, b, block, *args):
    """`solve(L, b, block, *args)`, identity-padding a ragged n > block."""
    n = L.shape[-1]
    if n > block and n % block != 0:
        np_ = _padded_n(n, block)
        return solve(_pad_identity(L, np_), _pad_rows(b, np_), block, *args)[:n]
    return solve(L, b, block, *args)


def cholesky_blocked_padded(A, block=1024, base=256, sym=False):
    """`blocked_cholesky` for any n: ragged sizes above `block` are
    identity-padded to the next panel multiple."""
    n = A.shape[-1]
    if n > block and n % block != 0:
        Lp = blocked_cholesky(_pad_identity(A, _padded_n(n, block)), block, base, sym)
        return Lp[:n, :n]
    return blocked_cholesky(A, block, base, sym)


def blocked_solve_lower(L, b, block=1024):
    """Solve L x = b by blocked forward substitution, with the closed-form
    O(N²) adjoint.  Ragged n > block is identity-padded."""
    return _padded(_SolveLower.apply, L, b, block)


def blocked_solve_upper_T(L, b, block=1024):
    """Solve Lᵀ x = b by blocked backward substitution (L lower), with the
    closed-form O(N²) adjoint.  Ragged n > block is identity-padded."""
    return _padded(_SolveUpperT.apply, L, b, block)

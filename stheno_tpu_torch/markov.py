"""State-space (Markov) GPs: exact O(N) inference by Kalman filtering, with
an O(log N)-depth parallel filter and smoother (counterpart of
`stheno_tpu/markov.py`).

A Matérn-(p+1/2) kernel on 1-D inputs is a (p+1)-state LTI SDE
`dz = F z dt + L dβ` observed through `H z` (Hartikainen & Särkkä 2010).
With the stationary start, the discretised process needs only
`A_k = expm(F Δt_k)` and `Q_k = P∞ − A_k P∞ A_kᵀ`.  Kernel algebra maps
structurally: variance scaling scales `P∞`, `with_lengthscale` divides `F`
by ℓ, kernel sums stack their states block-diagonally.  For gaps short
against ℓ the port computes `Q_k` by Van Loan's block exponential instead
(`_transition`): the same matrix, without the subtraction that loses its
small entries in f32.

The temporal parallelisation of Särkkä & García-Fernández (2021, "Temporal
Parallelization of Bayesian Smoothers", IEEE TAC) writes the filter and the
RTS smoother as associative combines of per-step affine-Gaussian elements.
PyTorch has no associative scan, so `associative_scan` here is the port's
own: the odd/even recursion of `lax.associative_scan`, log2(N) levels of
batched small-matrix products, each level one call of the combine on all
pairs at once.  Gradients flow through `torch.linalg.matrix_exp` and the
scan by plain autograd, as the reference's do through `expm` and
`lax.associative_scan` (it writes no custom VJP either).

Where the reference fails (ROADMAP §C), the port raises `ValueError`:
unsorted inputs (the reference silently returns a wrong value), and
per-point noise together with `x_star` (the reference fails with a shape
error).  The sortedness check costs one device reduction.

The functions run where their tensor inputs live.  Inputs that are not
tensors go to `device`, which defaults to `cuda` and raises without a card.
"""

from __future__ import annotations

import math

import torch

from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.kernels.base import (
    ScaledKernel,
    SumKernel,
    TransformedKernel,
    _LengthscaleTransform,
)
from stheno_tpu_torch.kernels.zoo import Matern12Kernel, Matern32Kernel, Matern52Kernel

__all__ = [
    "associative_scan",
    "sde_representation",
    "markov_gp_logpdf",
    "markov_gp_posterior_marginals",
]


def _num(v, dtype, device):
    """A hyperparameter as a tensor of `dtype` on `device` (autograd kept)."""
    if torch.is_tensor(v):
        return v.to(dtype=dtype, device=device)
    return torch.tensor(v, dtype=dtype, device=device)


def _sde_blocks(kernel, dtype, device):
    """The state-space forms of the kernel's summands, as a list of
    (F, H, Pinf); the kernel's own form stacks them block-diagonally."""
    if isinstance(kernel, (Matern12Kernel, Matern32Kernel, Matern52Kernel)):
        dev = resolve_device(device)
        t = lambda rows: torch.tensor(rows, dtype=dtype, device=dev)
        if isinstance(kernel, Matern12Kernel):
            return [(t([[-1.0]]), t([1.0]), t([[1.0]]))]
        if isinstance(kernel, Matern32Kernel):
            lam = math.sqrt(3.0)
            return [(t([[0.0, 1.0], [-3.0, -2.0 * lam]]), t([1.0, 0.0]), t([[1.0, 0.0], [0.0, 3.0]]))]
        lam = math.sqrt(5.0)
        k2 = lam**2 / 3.0  # variance of the first derivative
        F = t([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [-(lam**3), -3.0 * lam**2, -3.0 * lam]])
        Pinf = t([[1.0, 0.0, -k2], [0.0, k2, 0.0], [-k2, 0.0, lam**4]])
        return [(F, t([1.0, 0.0, 0.0]), Pinf)]
    if isinstance(kernel, ScaledKernel):
        blocks = _sde_blocks(kernel.kernel, dtype, device)
        var = _num(kernel.variance, dtype, blocks[0][0].device)
        return [(F, H, var * Pinf) for F, H, Pinf in blocks]
    if isinstance(kernel, TransformedKernel) and isinstance(kernel.transform, _LengthscaleTransform):
        blocks = _sde_blocks(kernel.kernel, dtype, device)
        ell = _num(kernel.transform.lengthscale, dtype, blocks[0][0].device)
        if ell.dim() != 0:
            raise TypeError("markov: with_lengthscale must be scalar for 1-D state-space inference")
        # k(x/ℓ, y/ℓ): the state runs on the time scale t/ℓ
        return [(F / ell, H, Pinf) for F, H, Pinf in blocks]
    if isinstance(kernel, SumKernel):
        return _sde_blocks(kernel.left, dtype, device) + _sde_blocks(kernel.right, dtype, device)
    raise TypeError(
        f"{type(kernel).__name__} has no (supported) Markov state-space form; supported: "
        "Matern12/32/52 and their scale / scalar-lengthscale / sum algebra")


def sde_representation(kernel, dtype=torch.float64, device="cuda"):
    """(F, H, Pinf) of the kernel's LTI-SDE state-space form: `F` (s, s)
    drift, `H` (s,) observation row, `Pinf` (s, s) stationary covariance.
    Supported: Matérn-1/2, -3/2, -5/2, `ScaledKernel`, `with_lengthscale`
    (scalar ℓ only) and `SumKernel`.  Raises TypeError for other kernels."""
    Fs, Hs, Ps = zip(*_sde_blocks(kernel, dtype, device))
    return torch.block_diag(*Fs), torch.cat(Hs), torch.block_diag(*Ps)


def _mv(M, v):
    """Batched matrix-vector product (n, s, s) × (n, s) → (n, s)."""
    return (M @ v[..., None])[..., 0]


def _quad(H, P):
    """H P Hᵀ for each P of a batch: (n,)."""
    return torch.einsum("i,nij,j->n", H, P, H)


#: Largest ‖F‖₁·Δ whose Q comes from Van Loan's block exponential; longer
#: gaps take P∞ − A P∞ Aᵀ.  The two forms' f32 errors against f64, relative
#: to √(Q_ii Q_jj), cross near here for Matérn-1/2, -3/2 and -5/2 (CPU,
#: `tests/test_torch_markov.py::test_transition_f32_over_all_gaps`): below
#: 0.5 the subtraction loses 1e-5 up to whole entries, at 16 the block
#: exponential loses up to 2e-4, and it overflows near 100.
VAN_LOAN_MAX = 3.0


def _transition(F, Pinf, d):
    """(A, Q) of one summand's state-space form over the gaps `d`, (n, s, s)
    each, A_k = expm(F Δ_k) and Q_k = ∫₀^Δ e^{Fu} Lc e^{Fᵀu} du with
    Lc = −(F P∞ + P∞ Fᵀ) (the stationary Lyapunov equation).

    Q is formed two ways.  Short gaps take Van Loan's (1978) block
    exponential exp([[F, Lc], [0, −Fᵀ]]·Δ) = [[A, G], [0, A⁻ᵀ]], Q = G Aᵀ.
    The reference's P∞ − A P∞ Aᵀ (`markov.py:136`) cancels there: its small
    entries (Q₁₁ is O(Δ³)) are lost in f32, which at N = 10⁶ on [0, 4000]
    cost the f32 variance gradient 3.5e-2 relative on an H100 (ROADMAP §C).
    Long gaps take the subtraction, which is exact there, while the block
    exponential's A⁻ᵀ grows as e^{λΔ/ℓ}.  The block exponential sees those
    gaps as 0, so neither its value nor its gradient can overflow."""
    s = F.shape[0]
    Lc = -(F @ Pinf + Pinf @ F.T)
    block = torch.cat([torch.cat([F, Lc], 1), torch.cat([torch.zeros_like(F), -F.T], 1)])
    short = d * torch.linalg.matrix_norm(F.detach(), 1) <= VAN_LOAN_MAX
    E = torch.linalg.matrix_exp(torch.where(short, d, 0.0)[:, None, None] * block)
    q_short = E[:, :s, s:] @ E[:, :s, :s].mT
    A = torch.linalg.matrix_exp(d[:, None, None] * F)
    Q = torch.where(short[:, None, None], q_short, Pinf - A @ Pinf @ A.mT)
    return A, 0.5 * (Q + Q.mT)


def _batched_block_diag(mats):
    """Block-diagonal stack of (n, s_i, s_i) batches: (n, Σs_i, Σs_i)."""
    if len(mats) == 1:
        return mats[0]
    size, at, rows = sum(m.shape[-1] for m in mats), 0, []
    for m in mats:
        rows.append(torch.nn.functional.pad(m, (at, size - at - m.shape[-1])))
        at += m.shape[-1]
    return torch.cat(rows, dim=-2)


def _discretise(kernel, x, dtype):
    """Batched (A_k, Q_k) over the gaps of sorted `x`, plus H.  A_0 = 0 and
    Q_0 = Pinf encode the stationary start.  Each summand of a sum is
    discretised on its own time scale (`_transition`), then stacked."""
    d = torch.diff(x.to(dtype))
    As, Qs, Hs = [], [], []
    for F, H, Pinf in _sde_blocks(kernel, dtype, x.device):
        A, Q = _transition(F, Pinf, d)
        As.append(torch.cat([torch.zeros_like(F)[None], A]))
        Qs.append(torch.cat([Pinf[None], Q]))
        Hs.append(H)
    return _batched_block_diag(As), _batched_block_diag(Qs), torch.cat(Hs)


# ---------------------------------------------------------------------------
# The associative scan
# ---------------------------------------------------------------------------


def _interleave(a, b):
    """[a0, b0, a1, b1, ...] along axis 0, len(a) − len(b) ∈ {0, 1}."""
    k = b.shape[0]
    ab = torch.stack([a[:k], b], dim=1).reshape(2 * k, *a.shape[1:])
    return torch.cat([ab, a[k:]]) if a.shape[0] > k else ab


def _scan(fn, elems):
    n = elems[0].shape[0]
    if n < 2:
        return elems
    # combine adjacent pairs, scan the half-length sequence, then fill in
    # the even positions from the odd prefixes
    odd = _scan(fn, fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems)))
    if n > 2:
        prev = tuple(e[:-1] for e in odd) if n % 2 == 0 else odd
        even = fn(prev, tuple(e[2::2] for e in elems))
        even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    else:
        even = tuple(e[:1] for e in elems)
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def associative_scan(fn, elems, reverse=False):
    """Inclusive scan of an associative `fn` over axis 0 of a tuple of
    tensors, in O(log N) depth: the odd/even recursion of
    `lax.associative_scan`.  `fn(a, b)` combines two tuples of equal-length
    batches, `a` the earlier.  With `reverse=True` the scan runs from the end
    and `fn` receives (later composite, current), as `lax`'s does."""
    elems = tuple(elems)
    if reverse:
        elems = tuple(torch.flip(e, [0]) for e in elems)
    out = _scan(fn, elems)
    if reverse:
        out = tuple(torch.flip(e, [0]) for e in out)
    return out


# ---------------------------------------------------------------------------
# Filter and smoother
# ---------------------------------------------------------------------------


def _filter_elements(A, Q, H, y, r, obs_mask):
    """Per-step associative filtering elements (A', b', C', η, J)
    (Särkkä & García-Fernández 2021, Lemma 8).  Masked steps (prediction
    sites) carry the pure predict element (A, 0, Q, 0, 0)."""
    s = A.shape[-1]
    S = _quad(H, Q) + r
    K = (Q @ H) / S[:, None]
    ImKH = torch.eye(s, dtype=A.dtype, device=A.device) - K[:, :, None] * H[None, None, :]
    AtH = A.mT @ H  # Aᵀ Hᵀ, (N, s)
    m = obs_mask[:, None]
    m2 = obs_mask[:, None, None]
    A_e = torch.where(m2, ImKH @ A, A)
    b_e = torch.where(m, K * y[:, None], 0.0)
    C_e = torch.where(m2, ImKH @ Q, Q)
    eta = torch.where(m, AtH * (y / S)[:, None], 0.0)
    J = torch.where(m2, AtH[:, :, None] * AtH[:, None, :] / S[:, None, None], 0.0)
    return A_e, b_e, C_e, eta, J


def _combine(e1, e2):
    """The associative filtering combine (Särkkä & García-Fernández 2021,
    Lemma 7); `e1` is the earlier element."""
    A1, b1, C1, n1, J1 = e1
    A2, b2, C2, n2, J2 = e2
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device).expand_as(C1)
    # (I + C1 J2)⁻¹, shared; its transpose is (I + J2 C1)⁻¹
    M = torch.linalg.solve(eye + C1 @ J2, eye)
    A2M = A2 @ M
    A1tMt = A1.mT @ M.mT
    return (
        A2M @ A1,
        _mv(A2M, b1 + _mv(C1, n2)) + b2,
        A2M @ C1 @ A2.mT + C2,
        _mv(A1tMt, n2 - _mv(J2, b1)) + n1,
        A1tMt @ J2 @ A1 + J1,
    )


def _parallel_filter(A, Q, H, y, r, obs_mask):
    """All filtered moments (m_k, P_k) in O(log N) depth."""
    _, b, C, _, _ = associative_scan(_combine, _filter_elements(A, Q, H, y, r, obs_mask))
    return b, C


def _sequential_filter(A, Q, H, y, r, obs_mask):
    """The sequential Kalman filter, one step per input (the oracle)."""
    s = A.shape[-1]
    m = A.new_zeros(s)
    P = A.new_zeros((s, s))
    ms, Ps = [], []
    for k in range(A.shape[0]):
        m = A[k] @ m
        P = A[k] @ P @ A[k].T + Q[k]
        S = H @ P @ H + r[k]
        K = (P @ H) / S
        m_u = m + K * (y[k] - H @ m)
        P_u = P - torch.outer(K, K) * S
        m = torch.where(obs_mask[k], m_u, m)
        P = torch.where(obs_mask[k], 0.5 * (P_u + P_u.T), P)
        ms.append(m)
        Ps.append(P)
    return torch.stack(ms), torch.stack(Ps)


def _predictive_loglik(A, Q, H, y, r, obs_mask, m_f, P_f):
    """Σ_k log N(y_k; H m_{k|k−1}, H P_{k|k−1} Hᵀ + r_k) from the filtered
    moments, elementwise (shifted by one step)."""
    m_prev = torch.cat([torch.zeros_like(m_f[:1]), m_f[:-1]])
    P_prev = torch.cat([torch.zeros_like(P_f[:1]), P_f[:-1]])
    mu = _mv(A, m_prev) @ H
    S = _quad(H, A @ P_prev @ A.mT + Q) + r
    ll = -0.5 * (torch.log(2.0 * math.pi * S) + (y - mu) ** 2 / S)
    return torch.sum(torch.where(obs_mask, ll, 0.0))


def _rts_smoother(A, Q, m_f, P_f):
    """The sequential Rauch–Tung–Striebel backward pass (the oracle)."""
    ms_next, Ps_next = m_f[-1], P_f[-1]
    out_m, out_P = [ms_next], [Ps_next]
    for k in reversed(range(A.shape[0] - 1)):
        m, P, A_next = m_f[k], P_f[k], A[k + 1]
        P_pred = A_next @ P @ A_next.T + Q[k + 1]
        G = torch.linalg.solve(P_pred.T, (P @ A_next.T).T).T
        ms = m + G @ (ms_next - A_next @ m)
        Ps = P + G @ (Ps_next - P_pred) @ G.T
        out_m.append(ms)
        out_P.append(Ps)
        ms_next, Ps_next = ms, 0.5 * (Ps + Ps.T)
    return torch.stack(out_m[::-1]), torch.stack(out_P[::-1])


def _smoother_combine(e1, e2):
    """Associative smoothing combine (Särkkä & García-Fernández 2021,
    Lemma 9): composition of affine-Gaussian maps, `e1` the outer one."""
    E1, g1, L1 = e1
    E2, g2, L2 = e2
    return E1 @ E2, _mv(E1, g2) + g1, E1 @ L2 @ E1.mT + L1


def _parallel_smoother(A, Q, m_f, P_f):
    """All smoothed moments in O(log N) depth by a reverse scan over the
    per-step elements (E, g, L): E_k = P_k A_{k+1}ᵀ P⁻¹_{k+1|k} (the RTS
    gain), g_k = m_k − E_k A m_k, L_k = P_k − E_k A P_k; the terminal
    element is (0, m_N, P_N)."""
    s = A.shape[-1]
    A_n = A[1:]
    P_pred = A_n @ P_f[:-1] @ A_n.mT + Q[1:]
    # E P_pred = P Aᵀ  ⇔  P_predᵀ Eᵀ = (P Aᵀ)ᵀ
    E = torch.linalg.solve(P_pred.mT, (P_f[:-1] @ A_n.mT).mT).mT
    g = m_f[:-1] - _mv(E @ A_n, m_f[:-1])
    L = P_f[:-1] - E @ A_n @ P_f[:-1]
    elems = (
        torch.cat([E, A.new_zeros((1, s, s))]),
        torch.cat([g, m_f[-1:]]),
        torch.cat([0.5 * (L + L.mT), P_f[-1:]]),
    )
    # the reverse scan delivers fn(later composite, current); the current
    # step is the outer map of the composition
    _, ms, Ps = associative_scan(lambda a, b: _smoother_combine(b, a), elems, reverse=True)
    return ms, Ps


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _device_of(x, device):
    if device is not None:
        return resolve_device(device)
    return x.device if torch.is_tensor(x) else resolve_device("cuda")


def _prep(kernel, x, y, noise, dtype, device=None):
    dev = _device_of(x, device)
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    if x.dim() != 1:
        raise TypeError("markov: inputs must be a sorted 1-D vector")
    if x.shape[0] > 1 and bool((x[1:] < x[:-1]).any()):
        raise ValueError("markov: inputs must be sorted ascending (the filter runs in input order)")
    dtype = dtype or torch.promote_types(x.dtype, y.dtype)
    A, Q, H = _discretise(kernel, x, dtype)
    y = y.to(dtype)
    r = torch.broadcast_to(_num(noise, dtype, dev), y.shape)
    return A, Q, H, y, r, dtype


def markov_gp_logpdf(kernel, x, y, noise, parallel=True, dtype=None, device=None):
    """Exact GP log marginal likelihood in O(N) work and O(log N) depth.

    Equals `logpdf(GP(kernel)(x, noise), y)` for Markov kernels; `noise` is
    the observation variance (scalar or per point).  `x` must be sorted
    ascending (checked).  `parallel=False` runs the sequential filter (the
    oracle)."""
    A, Q, H, y, r, _ = _prep(kernel, x, y, noise, dtype, device)
    mask = torch.ones(y.shape, dtype=torch.bool, device=y.device)
    flt = _parallel_filter if parallel else _sequential_filter
    m_f, P_f = flt(A, Q, H, y, r, mask)
    return _predictive_loglik(A, Q, H, y, r, mask, m_f, P_f)


def markov_gp_posterior_marginals(kernel, x, y, noise, x_star=None, parallel=True, dtype=None,
                                  device=None):
    """Posterior marginal (mean, var), at `x_star` if given, else at `x`.

    One filter and one smoother over the sorted union of `x` and `x_star`
    (prediction sites skip the update), so prediction costs the same
    O(N + N*) as training.  Per-point noise together with `x_star` raises
    ValueError."""
    dev = _device_of(x, device)
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    if x_star is None:
        xa, ya, take = x, y, None
        mask = torch.ones(x.shape, dtype=torch.bool, device=dev)
    else:
        if torch.as_tensor(noise, device=dev).dim() != 0:
            raise ValueError("markov: per-point noise together with x_star is not supported; "
                             "give a scalar noise variance")
        x_star = torch.as_tensor(x_star, device=dev).to(x.dtype)
        n, n_star = x.shape[0], x_star.shape[0]
        xcat = torch.cat([x, x_star])
        order = torch.argsort(xcat, stable=True)
        xa = xcat[order]
        ya = torch.cat([y, y.new_zeros(n_star)])[order]
        mask = torch.cat([torch.ones(n, dtype=torch.bool, device=dev),
                          torch.zeros(n_star, dtype=torch.bool, device=dev)])[order]
        # the sorted-union position of each x_star entry
        take = torch.argsort(order, stable=True)[n:]
    A, Q, H, ya, r, _ = _prep(kernel, xa, ya, noise, dtype, dev)
    flt = _parallel_filter if parallel else _sequential_filter
    m_f, P_f = flt(A, Q, H, ya, r, mask)
    smo = _parallel_smoother if parallel else _rts_smoother
    ms, Ps = smo(A, Q, m_f, P_f)
    mean, var = ms @ H, _quad(H, Ps)
    if take is not None:
        mean, var = mean[take], var[take]
    return mean, var

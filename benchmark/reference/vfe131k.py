"""Plain reference of the pseudo-point programme, in float64 with plain
PyTorch.

f1 = v1·SE(·/l1), f2 = v2·Matern52(·/l2), f3 = f1 + f2 observed at x under
noise variance σ² = `noise`; pseudo-points u = (f1 at z, f2 at z) under the
inducing noise ε (`inducing_noise`).  The loss is the negated Titsias
collapsed bound

    ELBO = log N(y; 0, Q_ff + σ²I) − tr(K_ff − Q_ff)/(2σ²),
    Q_ff = K_fu (K_uu + εI)⁻¹ K_uf,

which this file works out through G = K_uf K_ufᵀ and r = K_uf y (the
program goes through A = L_uu⁻¹ K_uf instead): with K = K_uu + εI and
C = σ²K + G,

    log det(Q_ff + σ²I) = log det C − log det K + (N − M) log σ²,
    yᵀ(Q_ff + σ²I)⁻¹ y = (yᵀy − rᵀC⁻¹r)/σ²,      tr Q_ff = tr(K⁻¹G).

G and r are summed over blocks of columns of K_uf.  The gradient in the
flat unconstrained θ (`LEAVES`; positive parameters as their logs, z as it
is) takes two passes: torch.autograd over the M × M stage gives Ḡ and r̄,
then each block's ⟨Ḡ, K_uf,b K_uf,bᵀ⟩ + ⟨r̄, K_uf,b y_b⟩ is differentiated
through its kernel matrices.  It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

_SQRT5 = math.sqrt(5.0)
#: Columns of K_uf a block holds.
COLS = 8192


def leaves(cfg):
    """The flat θ's leaves in the order of the keys sorted."""
    return (("l1", 1), ("l2", 1), ("noise", 1), ("v1", 1), ("v2", 1), ("z", cfg["m_per_latent"]))


def _unpack(cfg, raw):
    out, i = {}, 0
    for name, size in leaves(cfg):
        piece = raw[i:i + size]
        out[name] = piece if name == "z" else torch.exp(piece[0])  # value = exp(raw)
        i += size
    return out


def _k1(a, b, t):
    return t["v1"] * torch.exp(-0.5 * ((a[:, None] - b[None, :]) / t["l1"]) ** 2)


def _k2(a, b, t):
    s = _SQRT5 * torch.abs(a[:, None] - b[None, :]) / t["l2"]
    return t["v2"] * (1.0 + s + s * s / 3.0) * torch.exp(-s)


def kuf(z, x, t):
    """K_uf: f1 and f2 at z against f3 at x (2m × n)."""
    return torch.cat([_k1(z, x, t), _k2(z, x, t)])


def kuu(cfg, z, t):
    """K_uu + εI: f1 and f2 at z, independent of each other (2m × 2m)."""
    m = len(z)
    K = torch.zeros((2 * m, 2 * m), dtype=z.dtype, device=z.device)
    K[:m, :m] = _k1(z, z, t)
    K[m:, m:] = _k2(z, z, t)
    return K + cfg["inducing_noise"] * torch.eye(2 * m, dtype=z.dtype, device=z.device)


def neg_elbo_terms(cfg, n, yy, G, r, t, z):
    """−ELBO from G, r, yᵀy and the parameters."""
    noise = t["noise"]
    K = kuu(cfg, z, t)
    m = K.shape[0]
    Lk = torch.linalg.cholesky(K)
    Lc = torch.linalg.cholesky(noise * K + G)
    logdet = 2.0 * torch.log(torch.diagonal(Lc)).sum() - 2.0 * torch.log(torch.diagonal(Lk)).sum() \
        + (n - m) * torch.log(noise)
    quad = (yy - r @ torch.cholesky_solve(r[:, None], Lc)[:, 0]) / noise
    tr_q = torch.diagonal(torch.cholesky_solve(G, Lk)).sum()
    kff = n * (t["v1"] + t["v2"])
    elbo = -0.5 * (n * math.log(2.0 * math.pi) + logdet + quad) - (kff - tr_q) / (2.0 * noise)
    return -elbo


def value_and_grad(cfg, data, raw):
    """(−ELBO, gradient in `raw`), float64."""
    x = data["x"].to(torch.float64)
    y = data["y"].to(torch.float64)
    raw = raw.to(device=x.device, dtype=torch.float64).detach()
    n = len(x)
    with torch.no_grad():
        t = _unpack(cfg, raw)
        m = 2 * cfg["m_per_latent"]
        G = torch.zeros((m, m), dtype=torch.float64, device=x.device)
        r = torch.zeros(m, dtype=torch.float64, device=x.device)
        for i in range(0, n, COLS):
            kb = kuf(t["z"], x[i:i + COLS], t)
            G.addmm_(kb, kb.T)
            r.addmv_(kb, y[i:i + COLS])
    theta = raw.clone().requires_grad_(True)
    G.requires_grad_(True)
    r.requires_grad_(True)
    t = _unpack(cfg, theta)
    value = neg_elbo_terms(cfg, n, y @ y, G, r, t, t["z"])
    grad, G_bar, r_bar = torch.autograd.grad(value, [theta, G, r])
    G_bar, r_bar = G_bar.detach(), r_bar.detach()
    for i in range(0, n, COLS):
        theta_b = raw.clone().requires_grad_(True)
        t = _unpack(cfg, theta_b)
        kb = kuf(t["z"], x[i:i + COLS], t)
        part = (G_bar * (kb @ kb.T)).sum() + r_bar @ (kb @ y[i:i + COLS])
        (g,) = torch.autograd.grad(part, theta_b)
        grad = grad + g
    return float(value.detach()), grad.cpu()

"""Plain reference of the flagship programme, in float64 with plain PyTorch.

f1 = v1·SE(·/l1), f2 = Matern32(·/l2), f3 = f1 + f2; f3 observed at x under
noise variance σ² = `noise`; y has mean 0.  It imports nothing of the
program: every covariance, factor and solve is worked out here again from
the inputs the harness hands to both sides.

- `value_and_grad(cfg, data, raw)`: −log N(y; 0, K) with K = K1 + K2 + σ²I
  and its gradient in the flat unconstrained θ `raw`, laid out as `LEAVES`
  (each positive parameter as its log: value = exp(raw)).  The gradient is
  the closed form ½ Σᵢⱼ (K⁻¹ − ααᵀ)ᵢⱼ ∂Kᵢⱼ/∂rawₖ with α = K⁻¹y, summed in
  blocks of rows.
- `marginals(cfg, data, theta, queries)`: the posterior of f1 given f3 = y
  at x, its mean K1(q, x) α and variance v1 − ‖L⁻¹ K1(x, q)‖² + jitter at
  each query, with the prior variance v1 + jitter beside them.
"""

from __future__ import annotations

import math

import torch

#: The flat θ's leaves, in the order of the keys sorted, as the harness
#: hands them over.
LEAVES = (("l1", 1), ("l2", 1), ("noise", 1), ("v1", 1))
_SQRT3 = math.sqrt(3.0)
#: Rows a block of the covariance's gradient sums.
ROWS = 1024


def leaves(cfg):
    return LEAVES


def positive(raw):
    """The positive transform: value = exp(raw)."""
    return torch.exp(raw)


def constrained(raw):
    """The parameters as float64 numbers, from the flat unconstrained θ."""
    vals = positive(raw.to(torch.float64)).tolist()
    return dict(zip((name for name, _ in LEAVES), vals))


def _blocks(x, theta):
    """(rows, d, K1 block, Matern32 argument s, e^{-s}) for blocks of rows
    of the N × N covariance."""
    for i in range(0, len(x), ROWS):
        d = x[i:i + ROWS, None] - x[None, :]
        r1 = (d / theta["l1"]) ** 2
        k1 = theta["v1"] * torch.exp(-0.5 * r1)
        s = _SQRT3 * torch.abs(d) / theta["l2"]
        yield slice(i, i + ROWS), r1, k1, s, torch.exp(-s)


def covariance(x, theta):
    """K1 + K2 + σ²I at x (N × N, float64)."""
    K = torch.empty((len(x), len(x)), dtype=torch.float64, device=x.device)
    for rows, _, k1, s, es in _blocks(x, theta):
        K[rows] = k1 + (1.0 + s) * es
    K.diagonal().add_(theta["noise"])
    return K


def _factor(x, y, theta):
    K = covariance(x, theta)
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    return L, alpha


def value_and_grad(cfg, data, raw):
    """(−log p(y | θ), gradient in `raw`), float64."""
    x = data["x"].to(torch.float64)
    y = data["y"].to(torch.float64)
    theta = constrained(raw)
    n = len(x)
    L, alpha = _factor(x, y, theta)
    value = 0.5 * float(y @ alpha) + float(torch.log(torch.diagonal(L)).sum()) \
        + 0.5 * n * math.log(2.0 * math.pi)
    W = torch.cholesky_inverse(L)
    del L
    W.addr_(alpha, alpha, alpha=-1.0)  # K⁻¹ − ααᵀ
    g = dict(l1=0.0, l2=0.0, noise=0.0, v1=0.0)
    for rows, r1, k1, s, es in _blocks(x, theta):
        w = W[rows]
        g["v1"] += float((w * k1).sum())  # ∂K/∂log v1 = K1
        g["l1"] += float((w * k1 * r1).sum())  # ∂K1/∂log l1 = K1 · (d/l1)²
        g["l2"] += float((w * s * s * es).sum())  # ∂K2/∂log l2 = s² e^{-s}
    g["noise"] = theta["noise"] * float(torch.diagonal(W).sum())  # ∂K/∂log σ² = σ²I
    grad = torch.tensor([0.5 * g[name] for name, _ in LEAVES], dtype=torch.float64)
    return value, grad


def marginals(cfg, data, theta, queries):
    """[(mean, var, prior var)] of f1 at each query (float64 on the CPU)."""
    x = data["x"].to(torch.float64)
    y = data["y"].to(torch.float64)
    theta = {k: float(v) for k, v in theta.items()}
    jitter = cfg["query_noise"]
    L, alpha = _factor(x, y, theta)
    out = []
    for xq in queries:
        xq = xq.to(device=x.device, dtype=torch.float64)
        k1 = theta["v1"] * torch.exp(-0.5 * ((x[:, None] - xq[None, :]) / theta["l1"]) ** 2)
        mean = k1.T @ alpha
        A = torch.linalg.solve_triangular(L, k1, upper=False)
        var = theta["v1"] - (A * A).sum(0) + jitter
        prior = torch.full_like(var, theta["v1"] + jitter)
        out.append((mean.cpu(), var.cpu(), prior.cpu()))
    return out

"""Plain reference of the two-output Mauna Loa programme (Stheno.jl's
`examples/extended_mauna_loa`), in float64 with plain PyTorch.  It imports
nothing of the program: every covariance block, factor and solve is worked
out here again from the inputs the harness hands to both sides.

The model, SE(r) = exp(−r²/2), d = t − t′:

- f_trend = SE(ts·d), ts = `trend_scale`;
- f_co2 = s_latent·f_trend + s_wiggle·SE(l_wiggle·d)
  + s_period·SE(‖e(t) − e(t′)‖), e(t) = [cos 2πft, sin 2πft],
  + s_mean·1;
- f_T = s_trend·f_trend + s_wiggle′·SE(l_wiggle′·d) + s_mean′·1;
- each output observed under its own noise variance s_noise², the joint
  y = [y_co2; y_T] with mean 0.

So K(co2, co2) = s_latent²·K_trend + s_wiggle²·K_w + s_period²·K_p
+ s_mean² + s_noise²·I, K(T, T) likewise without the periodic term, and the
cross block K(co2, T) = s_latent·s_trend·K_trend.  ‖e(t) − e(t′)‖² is
written as 4 sin²(πf·d), the same number.  Departures from the example:
none in the model (f fixed at 1, every other parameter trained); its data
are the example's recipe at N = 16384 (`configs/mauna_loa16k.json`).

- `leaves(cfg)`: the flat θ's leaves, the configuration's `theta` keys
  sorted (nested ones as `co2.s_latent`), its `fixed` ones left out.
- `value_and_grad(cfg, data, raw)`: −log N(y; 0, K) and its gradient in
  the flat unconstrained θ `raw` (each free leaf positive as exp(raw)): the
  closed form ½ Σᵢⱼ (K⁻¹ − ααᵀ)ᵢⱼ ∂Kᵢⱼ/∂rawₖ with α = K⁻¹y, summed in
  blocks of rows.
"""

from __future__ import annotations

import contextlib
import math

import torch

#: Rows a block of the covariance's gradient sums.
ROWS = 1024


def _flat(tree, prefix=""):
    for key in sorted(tree):
        name, value = prefix + key, tree[key]
        if isinstance(value, dict):
            yield from _flat(value, name + ".")
        else:
            yield name, value


def leaves(cfg):
    return tuple((name, 1) for name, _ in _flat(cfg["theta"]) if name not in cfg["fixed"])


def constrained(cfg, raw):
    """Every parameter as a float64 number: a free leaf exp(raw), a fixed
    one the configuration's value."""
    theta = dict(_flat(cfg["theta"]))
    names = [name for name, _ in leaves(cfg)]
    theta.update(zip(names, torch.exp(raw.to(torch.float64)).tolist()))
    return theta


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _observations(data):
    """(times of each output, y), float64."""
    xs = tuple(data[k].to(torch.float64) for k in ("x_co2", "x_T"))
    y = torch.cat([data["y_co2"], data["y_T"]]).to(torch.float64)
    return xs, y


def _parts(th, i, j, d):
    """{leaf: ∂K/∂raw of the block between outputs i and j (0 co2, 1 T) at
    differences d}, the noise left out, and that block of K."""
    sl, st, ts = th["co2.s_latent"], th["temp.s_trend"], th["trend_scale"]
    r2 = (ts * d) ** 2
    k_trend = torch.exp(-0.5 * r2)
    if i != j:  # s_latent·s_trend·K_trend
        k = sl * st * k_trend
        return {"co2.s_latent": k, "temp.s_trend": k, "trend_scale": -r2 * k}, k
    out = "co2" if i == 0 else "temp"
    s = sl if i == 0 else st
    sw, lw, sm = th[f"{out}.s_wiggle"], th[f"{out}.l_wiggle"], th[f"{out}.s_mean"]
    w2 = (lw * d) ** 2
    k_w = torch.exp(-0.5 * w2)
    parts = {("co2.s_latent" if i == 0 else "temp.s_trend"): 2.0 * s * s * k_trend,
             "trend_scale": -s * s * r2 * k_trend,
             f"{out}.s_wiggle": 2.0 * sw * sw * k_w,
             f"{out}.l_wiggle": -sw * sw * w2 * k_w,
             f"{out}.s_mean": torch.full_like(d, 2.0 * sm * sm)}
    k = s * s * k_trend + sw * sw * k_w + sm * sm
    if i == 0:
        sp = th["co2.s_period"]
        k_p = torch.exp(-2.0 * torch.sin(math.pi * th["co2.freq"] * d) ** 2)
        parts["co2.s_period"] = 2.0 * sp * sp * k_p
        k = k + sp * sp * k_p
    return parts, k


def _blocks(xs, th):
    """(rows, i, j, cols, parts, K block) over blocks of at most `ROWS` rows
    of each output against each output's columns."""
    starts = (0, len(xs[0]))
    for i, xi in enumerate(xs):
        for r in range(0, len(xi), ROWS):
            a = xi[r:r + ROWS]
            rows = slice(starts[i] + r, starts[i] + r + len(a))
            for j, xj in enumerate(xs):
                cols = slice(starts[j], starts[j] + len(xj))
                parts, k = _parts(th, i, j, a[:, None] - xj[None, :])
                yield rows, i, j, cols, parts, k


def _noise(xs, th):
    return torch.cat([torch.full((len(xs[0]),), th["co2.s_noise"] ** 2, dtype=torch.float64),
                      torch.full((len(xs[1]),), th["temp.s_noise"] ** 2, dtype=torch.float64)])


def covariance(xs, th):
    """The joint covariance of [y_co2; y_T] (N × N, float64)."""
    n = len(xs[0]) + len(xs[1])
    K = torch.empty((n, n), dtype=torch.float64, device=xs[0].device)
    for rows, _, _, cols, _, k in _blocks(xs, th):
        K[rows, cols] = k
    K.diagonal().add_(_noise(xs, th).to(K.device))
    return K


def value_and_grad(cfg, data, raw):
    """(−log p(y | θ), gradient in `raw`), float64."""
    with _no_tf32():
        th = constrained(cfg, raw)
        xs, y = _observations(data)
        n = len(y)
        K = covariance(xs, th)
        L = torch.linalg.cholesky(K)
        del K
        alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
        value = 0.5 * float(y @ alpha) + float(torch.log(torch.diagonal(L)).sum()) \
            + 0.5 * n * math.log(2.0 * math.pi)
        W = torch.cholesky_inverse(L)
        del L
        W.addr_(alpha, alpha, alpha=-1.0)  # K⁻¹ − ααᵀ
        g = dict.fromkeys((name for name, _ in leaves(cfg)), 0.0)
        for rows, _, _, cols, parts, _ in _blocks(xs, th):
            w = W[rows, cols]
            for name, dk in parts.items():
                g[name] += float((w * dk).sum())
        diag = torch.diagonal(W)
        n_co2 = len(xs[0])
        g["co2.s_noise"] += 2.0 * th["co2.s_noise"] ** 2 * float(diag[:n_co2].sum())  # ∂(s²)/∂log s = 2s²
        g["temp.s_noise"] += 2.0 * th["temp.s_noise"] ** 2 * float(diag[n_co2:].sum())
        grad = torch.tensor([0.5 * g[name] for name, _ in leaves(cfg)], dtype=torch.float64)
    return value, grad

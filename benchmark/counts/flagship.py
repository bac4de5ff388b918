"""The flagship programme's work, counted from the problem and not from the
program that solves it, so a change that drops work does not move its own
yardstick.  N observations of f3 = f1 + f2 under noise, Q query points.

- `fit`, one value + gradient step: the factor L Lᵀ = K costs N³/3; the
  gradient of ½ yᵀK⁻¹y + ½ log det K in θ needs ½ tr((K⁻¹ − ααᵀ) ∂K/∂θ),
  so K⁻¹ itself: L⁻¹ (N³/3) and L⁻ᵀ L⁻¹ (N³/3, one triangle).  N³ in all;
  the solves and the elementwise passes are O(N²).
- `query`, one request against a held posterior (L and α = K⁻¹y kept):
  the variances need L⁻¹ K(x, x_q), a triangular solve with Q right-hand
  sides (N²·Q), and their column sums of squares (2·N·Q); the means are
  K(x_q, x) α (2·N·Q).
- `predict`, one request with its own data: the factor (N³/3), α by two
  triangular solves (2·N²), and a query's N²·Q + 4·N·Q.  (`chip_smoke.py`
  counted 2·N²·Q here, two solves with Q right-hand sides; the variances
  need one, the means none.)
"""


def flops(cfg, kind, traffic):
    n = cfg["n"]
    if kind == "fit":
        return float(n) ** 3
    q = traffic["points"]
    query = float(n) ** 2 * q + 4.0 * n * q
    if kind == "query":
        return query
    if kind == "predict":
        return float(n) ** 3 / 3 + 2.0 * n * n + query
    return None

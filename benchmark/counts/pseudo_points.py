"""The pseudo-point programme's work, counted from the problem: N
observations, M inducing points in all (both latents), the collapsed
Titsias bound and its gradient.

The bound depends on K_uf (M × N) only through G = K_uf K_ufᵀ and K_uf y
(and on K_uu, M × M):

    ELBO = log N(y; 0, Q_ff + σ²I) − tr(K_ff − Q_ff)/(2σ²),
    Q_ff = K_fu K_uu⁻¹ K_uf,

with log det(Q_ff + σ²I) = log det(K_uu + G/σ²) − log det K_uu + N log σ²,
yᵀ(Q_ff + σ²I)⁻¹y = (yᵀy − rᵀ(σ²K_uu + G)⁻¹r)/σ² for r = K_uf y, and
tr Q_ff = tr(K_uu⁻¹ G).  So a step needs G, one triangle of a rank-N
product (M²·N), and the gradient of K_uf, K̄_uf = (Ḡ + Ḡᵀ) K_uf (2·M²·N):
3·M²·N in all.  The factors of M × M matrices are O(M³) = O(M²·N · M/N)
and left out, so the count is a lower bound.  (`chip_smoke.py` counted
10·M²·N, what the port's A = L_uu⁻¹ K_uf route computes; a route with less
work would then read above 100 % of the peak.)
"""


def flops(cfg, kind, traffic):
    if kind != "fit":
        return None
    m = 2 * cfg["m_per_latent"]
    return 3.0 * m * m * cfg["n"]

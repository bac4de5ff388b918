"""The two-output Mauna Loa programme's work, counted from the problem and
not from the program that solves it: N = n_co2 + n_T joint observations of
(f_co2, f_T) under noise, one covariance over both outputs.

- `fit`, one value + gradient step: as for the flagship (`counts/flagship.py`),
  the factor L Lᵀ = K (N³/3) and K⁻¹ for ½ tr((K⁻¹ − ααᵀ) ∂K/∂θ) (2·N³/3):
  N³ in all.  The covariance's blocks and their reverse are O(N²) a
  component and left out, so the count is a lower bound.
"""


def flops(cfg, kind, traffic):
    if kind != "fit":
        return None
    return float(cfg["n_co2"] + cfg["n_T"]) ** 3

"""Sampler diagnostics: split-R̂ and bulk ESS (counterpart of
`stheno_tpu/inference/diagnostics.py`).

The standard Vehtari et al. (2021) formulations in their basic (non-rank)
form, with the autocorrelation by FFT (`torch.fft`), so the diagnostics run
on the tensors' device.  Same arithmetic as the reference, step for step.
"""

from __future__ import annotations

import math

import torch


def split_chains(x):
    """(C, S, ...) -> (2C, S//2, ...)"""
    half = x.shape[1] // 2
    return torch.cat([x[:, :half], x[:, half:2 * half]], dim=0)


def potential_scale_reduction(x):
    """Split-R̂ for (C, S) or (C, S, D) chains; returns a 0-d tensor or (D,)."""
    x = split_chains(torch.as_tensor(x))
    s = x.shape[1]
    chain_mean = torch.mean(x, dim=1)
    chain_var = torch.var(x, dim=1, correction=1)
    between = s * torch.var(chain_mean, dim=0, correction=1)
    within = torch.mean(chain_var, dim=0)
    var_est = (s - 1) / s * within + between / s
    return torch.sqrt(var_est / within)


def _autocov(x):
    """Per-chain autocovariance via FFT: x is (C, S); returns (C, S)."""
    s = x.shape[1]
    xc = x - torch.mean(x, dim=1, keepdim=True)
    n_fft = 2 * s
    f = torch.fft.rfft(xc, n=n_fft, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=n_fft, dim=1)[:, :s]
    return acov / s


def effective_sample_size(x):
    """Bulk ESS for (C, S) or (C, S, D); returns a 0-d tensor or (D,).

    Geyer's initial monotone positive sequence over chain-averaged
    autocorrelations (the Stan estimator)."""
    x = torch.as_tensor(x)
    if x.dim() == 3:
        return torch.stack([effective_sample_size(x[..., i]) for i in range(x.shape[-1])])
    x = split_chains(x)
    c, s = x.shape
    if s < 4:
        # too few draws for the Geyer pairing: no meaningful estimate
        return torch.tensor(math.nan, dtype=x.dtype, device=x.device)
    acov = _autocov(x)
    chain_var = acov[:, 0] * s / (s - 1.0)
    within = torch.mean(chain_var)
    mean_acov = torch.mean(acov, dim=0)
    between = torch.var(torch.mean(x, dim=1), correction=1)
    var_est = (s - 1.0) / s * within + between

    rho = 1.0 - (within - mean_acov) / var_est
    rho[0] = 1.0

    # Geyer pairs P_t = rho_2t + rho_2t+1, cut at the first negative one and
    # made monotone decreasing
    t_max = s // 2
    pairs = rho[0:2 * t_max:2] + rho[1:2 * t_max:2]
    pos = pairs > 0
    first_neg = torch.argmax((~pos).to(torch.int8))
    cutoff = torch.where(pos.all(), t_max, first_neg)
    mask = torch.arange(t_max, device=x.device) < cutoff
    inf = torch.tensor(math.inf, dtype=x.dtype, device=x.device)
    pairs_mono = torch.cummin(torch.where(mask, pairs, inf), dim=0).values
    pairs = torch.where(mask, torch.clamp(pairs_mono, min=0.0), 0.0)
    tau = -1.0 + 2.0 * torch.sum(pairs)
    ess = c * s / torch.clamp(tau, min=1.0 / math.log10(float(s)))
    return torch.clamp(ess, max=float(c * s))

"""Sequential Monte Carlo over hyperparameter space (counterpart of
`stheno_tpu/inference/smc.py`): adaptive tempering with systematic
resampling and HMC mutations.

- Particles move through the tempered family π_β ∝ prior · likelihood^β;
- β grows so that the conditional ESS of the incremental weights stays
  near `ess_target` (30 bisection steps on the device, no host round trip);
- systematic resampling;
- `num_mcmc` HMC steps at the new temperature mutate every particle at
  once: the particles are a (P, d) batch, and each leapfrog evaluates the
  tempered log-density of all of them through `torch.func.vmap`, one
  batched launch of kernel 1 for a GP likelihood.

Checkpoint and resume: stage i draws from the generator of (seed, smc, i)
alone, so a run cut into segments (`smc_init` → `smc_segment`* →
`smc_result`) equals the whole `run_smc` bit for bit on one device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from stheno_tpu_torch.inference.hmc import (
    _SMC,
    BatchedLogDensity,
    GeneratorDraws,
    _hmc_step,
    generator,
)
from stheno_tpu_torch.tree import ravel_pytree


class SMCState(NamedTuple):
    """The reference's named tuple of a tempering run's state, which it
    exports and never uses; a run here is carried by `SMCCheckpoint`, the
    same fields and the tempering history."""

    particles: torch.Tensor  # (P, d)
    log_like: torch.Tensor  # (P,)
    beta: torch.Tensor
    log_evidence: torch.Tensor
    step: torch.Tensor


class SMCCheckpoint(NamedTuple):
    """Resumable SMC run state (checkpointable with `inference.checkpoint`)."""

    particles: torch.Tensor  # (P, d) flat particles
    log_like: torch.Tensor  # (P,)
    beta: torch.Tensor
    log_evidence: torch.Tensor
    step: torch.Tensor
    betas: torch.Tensor  # (max_stages,) tempering history, NaN-padded


class SMCResult(NamedTuple):
    particles: object  # tree of (P, ...)
    log_evidence: torch.Tensor
    num_stages: torch.Tensor
    beta_history: torch.Tensor


def _systematic_resample(u, weights, n):
    """Systematic resampling from the uniform `u`: O(P), by searchsorted."""
    positions = (u + torch.arange(n, dtype=weights.dtype, device=weights.device)) / n
    cum = torch.cumsum(weights, dim=0)
    cum = cum / cum[-1]
    return torch.searchsorted(cum, positions)


def _conditional_ess(log_like, beta_old, beta_new):
    lw = (beta_new - beta_old) * log_like
    lw = lw - torch.max(lw)
    w = torch.exp(lw)
    return torch.sum(w) ** 2 / torch.sum(w * w)


def _next_beta(log_like, beta, ess_target_frac, n_particles, iters=30):
    """Bisection for the largest β' ≤ 1 with cESS ≥ target."""
    target = ess_target_frac * n_particles
    full = torch.ones((), dtype=log_like.dtype, device=log_like.device)
    lo, hi = torch.as_tensor(beta, dtype=log_like.dtype, device=log_like.device), full
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = _conditional_ess(log_like, beta, mid) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(_conditional_ess(log_like, beta, full) >= target, full, lo)


def _flat_fns(loglike_fn, logprior_fn, example_particles):
    """The log-likelihood and log-prior of one flat particle (d,), from the
    functions of one particle as a tree."""
    _, unravel_one = ravel_pytree(_first(example_particles))
    return (lambda q: loglike_fn(unravel_one(q))), (lambda q: logprior_fn(unravel_one(q)))


def _first(tree):
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_first(v) for v in tree)
    return tree[0]


def _stage(flat_loglike, flat_logprior, ck: SMCCheckpoint, gen, num_mcmc, ess_target,
           hmc_step_size, hmc_num_steps, gather=None, rows=None):
    """One tempering stage: the single code path of `run_smc`, `smc_segment`
    and `parallel.run_smc_sharded`, so segmented, whole and sharded runs are
    bit-identical.  Sharded, `ck` holds this process's particles [a, b) =
    `rows`, and `gather` maps a per-particle tensor to every particle's:
    each process computes the same tempering step and global resampling,
    and keeps its rows."""
    gather = gather if gather is not None else (lambda t: t)
    log_like = gather(ck.log_like)
    P_, d = log_like.shape[0], ck.particles.shape[1]
    a, b = rows if rows is not None else (0, P_)
    dt, dev = ck.particles.dtype, ck.particles.device
    beta_new = _next_beta(log_like, ck.beta, ess_target, P_)

    # incremental weights and the evidence
    lw = (beta_new - ck.beta) * log_like
    lw_max = torch.max(lw)
    w = torch.exp(lw - lw_max)
    log_evidence = ck.log_evidence + lw_max + torch.log(torch.mean(w))

    u = torch.rand((), generator=gen, dtype=dt, device=dev)
    particles = gather(ck.particles)[_systematic_resample(u, w, P_)[a:b]]

    # mutate every particle with HMC at the new temperature
    ld_and_grad = BatchedLogDensity(lambda q: flat_logprior(q) + beta_new * flat_loglike(q))
    eps = torch.tensor(hmc_step_size, dtype=dt, device=dev)
    inv_mass = torch.ones((b - a, d), dtype=dt, device=dev)
    logp, grad = ld_and_grad(particles)
    draws = GeneratorDraws(gen, P_, dt, dev, rows=(a, b))
    for _ in range(num_mcmc):
        particles, logp, grad, _ = _hmc_step(ld_and_grad, hmc_num_steps, draws, particles, logp,
                                             grad, eps, inv_mass)
    betas = ck.betas.clone()
    betas[int(ck.step)] = beta_new
    return SMCCheckpoint(particles=particles, log_like=torch.func.vmap(flat_loglike)(particles),
                         beta=beta_new, log_evidence=log_evidence, step=ck.step + 1, betas=betas)


def smc_init(loglike_fn, logprior_fn, init_particles, max_stages=50):
    """The initial `SMCCheckpoint` from prior draws (a tree of (P, ...))."""
    flat_p, _ = ravel_pytree(init_particles, batch_ndim=1)
    flat_loglike, _ = _flat_fns(loglike_fn, logprior_fn, init_particles)
    dt, dev = flat_p.dtype, flat_p.device
    with torch.no_grad():
        log_like = torch.func.vmap(flat_loglike)(flat_p)
    return SMCCheckpoint(
        particles=flat_p,
        log_like=log_like,
        beta=torch.zeros((), dtype=dt, device=dev),
        log_evidence=torch.zeros((), dtype=dt, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        betas=torch.full((max_stages,), math.nan, dtype=dt, device=dev),
    )


def smc_finished(state: SMCCheckpoint, max_stages=50):
    """Has the tempering run ended (β = 1, or `max_stages` stages)?"""
    return bool(state.beta >= 1.0) or int(state.step) >= max_stages


def smc_segment(
    seed,
    loglike_fn,
    logprior_fn,
    example_particles,
    state: SMCCheckpoint,
    num_stages,
    num_mcmc=5,
    ess_target=0.5,
    max_stages=50,
    hmc_step_size=0.2,
    hmc_num_steps=16,
    gather=None,
    rows=None,
):
    """Advance an SMC run by at most `num_stages` tempering stages.

    `seed` is the run's top-level seed (the one every segment and `run_smc`
    receive): stage i draws from the generator of (seed, smc, i), so any
    segmentation, none included, gives the same run.  Stages past the end
    are not run.  `example_particles` gives the particles' tree structure
    (e.g. the `init_particles` of `smc_init`).  `gather` and `rows` run a
    slice of the particles as `_stage` says (`parallel.run_smc_sharded`)."""
    flat_loglike, flat_logprior = _flat_fns(loglike_fn, logprior_fn, example_particles)
    with torch.no_grad():
        for _ in range(int(num_stages)):
            if smc_finished(state, max_stages):
                break
            gen = generator(seed, _SMC, int(state.step), state.particles.device)
            state = _stage(flat_loglike, flat_logprior, state, gen, num_mcmc, ess_target,
                           hmc_step_size, hmc_num_steps, gather, rows)
    return state


def smc_result(state: SMCCheckpoint, example_particles) -> SMCResult:
    """A (finished or partial) checkpoint as an `SMCResult`."""
    _, unravel_one = ravel_pytree(_first(example_particles))
    return SMCResult(particles=unravel_one(state.particles), log_evidence=state.log_evidence,
                     num_stages=state.step, beta_history=state.betas)


def run_smc(
    seed,
    loglike_fn,
    logprior_fn,
    init_particles,
    num_mcmc=5,
    ess_target=0.5,
    max_stages=50,
    hmc_step_size=0.2,
    hmc_num_steps=16,
):
    """Adaptive-tempering SMC from prior draws `init_particles` (a tree of
    (P, ...)) to the end: β = 1 or `max_stages` stages.  Returns an
    `SMCResult`: the final particles (≈ draws from prior · likelihood) and
    the log-evidence estimate.  `smc_init` → `smc_segment`* → `smc_result`
    with the same `seed` gives the same result, bit for bit on one device."""
    state = smc_init(loglike_fn, logprior_fn, init_particles, max_stages)
    state = smc_segment(seed, loglike_fn, logprior_fn, init_particles, state, max_stages,
                        num_mcmc, ess_target, max_stages, hmc_step_size, hmc_num_steps)
    return smc_result(state, init_particles)

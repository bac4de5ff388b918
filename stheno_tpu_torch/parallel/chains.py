"""Chain and particle parallelism over a `('chains',)` mesh axis
(counterpart of `stheno_tpu/parallel/chains.py`).

NUTS chains are embarrassingly parallel (each adapts its own step size and
mass), so rank r runs chains [r·C/P, (r+1)·C/P) through `run_nuts` itself
(its `chains` argument).  The port's samplers draw every chain's numbers
from one generator per transition (`inference.hmc.GeneratorDraws`), so each
rank draws the whole batch and keeps its slice: the sharded run equals
`run_nuts` chain for chain.

`run_smc_sharded` shards the particle axis through `smc_segment` (its
`gather` and `rows` arguments).  Each stage gathers the log-likelihoods
(P numbers), every rank computes the same tempering step and draws the
same global resampling indices from the same generator, and the particles
are exchanged by an `all_gather` of the (P, d) particle array; the HMC
mutations then run on the rank's particles, with the batch's draws sliced
as for NUTS.
"""

from __future__ import annotations

from stheno_tpu_torch.inference.hmc import run_nuts
from stheno_tpu_torch.inference.smc import smc_init, smc_result, smc_segment
from stheno_tpu_torch.parallel.collectives import Axis, all_gather
from stheno_tpu_torch.tree import ravel_pytree


def run_nuts_sharded(seed, logdensity_fn, init_position, mesh, num_warmup=500, num_samples=500,
                     num_chains=None, axis_name="chains", **kwargs):
    """`inference.run_nuts` with the chains sharded over `mesh`.

    `num_chains` defaults to one chain a rank and must be a multiple of the
    axis size.  Returns `(samples, info)` of this rank's chains (the leading
    chain axis is this rank's slice), equal to those chains of `run_nuts`
    with the same seed.  The split-R̂ check runs on the gathered draws.
    Every other keyword (`precision`, `max_depth`, ...) goes to `run_nuts`."""
    ax = Axis(mesh, axis_name)
    num_chains = num_chains if num_chains is not None else ax.size
    if num_chains % ax.size != 0:
        raise ValueError(f"num_chains={num_chains} not divisible by mesh axis {ax.size}")
    a, b = ax.rows(num_chains)
    return run_nuts(seed, logdensity_fn, init_position, num_warmup=num_warmup,
                    num_samples=num_samples, num_chains=num_chains, chains=(a, b, num_chains),
                    gather=lambda qs: all_gather(qs, ax), **kwargs)


def run_smc_sharded(seed, loglike_fn, logprior_fn, init_particles, mesh, axis_name="chains",
                    num_mcmc=5, ess_target=0.5, max_stages=50, hmc_step_size=0.2,
                    hmc_num_steps=16):
    """`inference.run_smc` with the particle axis sharded over `mesh`.
    `init_particles` (a tree of (P, ...)) is given whole on every rank.
    Returns an `SMCResult` whose particles are this rank's rows; the
    log-evidence, stage count and tempering history are whole, and the
    run equals `run_smc` with the same seed."""
    ax = Axis(mesh, axis_name)
    flat_all, _ = ravel_pytree(init_particles, batch_ndim=1)
    a, b = ax.rows(flat_all.shape[0])
    local = _slice_tree(init_particles, a, b)
    state = smc_init(loglike_fn, logprior_fn, local, max_stages)
    state = smc_segment(seed, loglike_fn, logprior_fn, local, state, max_stages, num_mcmc,
                        ess_target, max_stages, hmc_step_size, hmc_num_steps,
                        gather=lambda t: all_gather(t, ax), rows=(a, b))
    return smc_result(state, local)


def _slice_tree(tree, a, b):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, a, b) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slice_tree(v, a, b) for v in tree)
    return tree[a:b]


__all__ = ["run_nuts_sharded", "run_smc_sharded"]

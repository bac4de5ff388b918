"""The chains × rows multi-device dry run (counterpart of
`__graft_entry__.dryrun_multichip`): the distributed tier on a 2-D
`("chains", "rows")` mesh with a sampler on top, on `torch.distributed`
(NCCL on cards, gloo when the caller asks for the CPU).

    from stheno_tpu_torch.multichip import dryrun_multichip
    dryrun_multichip()                    # every rank of the job, on cuda

Every rank of the job calls it (SPMD); with no process group it makes a
one-rank group of its own, and destroys it at the end.  The ranks form a
grid of `chains × rows` (rows 4 or 2 where it divides the rank count and
the count exceeds it, else 1), on which it runs four stages:

1. one NUTS transition (`max_depth=5`) of 2 × chains chains, the chains
   sharded over 'chains', each chain's log-density a rows-sharded
   `big_gp_logpdf` (N = 512, block 64: eight panels, the block-cyclic
   route): `logdensity(q) = big_gp_logpdf(SE(·/e^{q0}), noise e^{q1}) − ½‖q‖²`;
2. `sharded_logpdf` of the composite programme f3 = v·SE + Matern32 with
   its gradient in v, and `sharded_posterior`'s f1 marginals at 8 points;
3. `ring_gp_logpdf` with its gradient in the lengthscale (4 probes, 6
   Lanczos iterations, at most 64 CG iterations);
4. an `svgp_elbo_dp` Bernoulli step (16 inducing points) over a 'data'
   mesh of every rank.

The log-density of stage 1 runs collectives, which `vmap` cannot carry, so
the transition evaluates this rank's chains one after another
(`nuts_kernel(..., sequential=True)`), and each evaluation's values are
broadcast from the rows axis's rank 0 (`agree`): the ranks of one rows
group take the same tree decisions and issue the same collectives.  The
draws are those of the whole batch of chains (`chains=(a, b, C)`), so the
grid's transition equals `nuts_kernel` over all chains on one process bit
for bit where the rows axis has one rank.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from stheno_tpu_torch import cuda as kern
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.gppp import gppp
from stheno_tpu_torch.graph import GP, GPC
from stheno_tpu_torch.inference import SVGP, BernoulliLikelihood, svgp_init
from stheno_tpu_torch.inference.hmc import _SAMPLE, generator, nuts_kernel
from stheno_tpu_torch.inputs import GPPPInput
from stheno_tpu_torch.kernels import Matern32Kernel, SEKernel, with_lengthscale
from stheno_tpu_torch.parallel import (
    big_gp_logpdf,
    data_mesh,
    grid_mesh,
    multihost,
    shard_rows,
    sharded_logpdf,
    sharded_posterior,
    svgp_elbo_dp,
)
from stheno_tpu_torch.parallel import collectives as coll
from stheno_tpu_torch.parallel.collectives import Axis, all_gather, broadcast
from stheno_tpu_torch.parallel.ring import ring_gp_logpdf

#: the configuration: N points, the panel width (eight panels, the
#: block-cyclic route); the transition's tree depth, step size and seed
N_OBS, BLOCK = 512, 64
NUTS_DEPTH = 5
NUTS_EPS = 0.1
NUTS_SEED = 0


def grid_shape(n_devices):
    """(chains, rows) of `n_devices` ranks: rows 4 or 2 where it divides
    the count and the count exceeds it, else 1."""
    rows = 1
    for cand in (4, 2):
        if n_devices % cand == 0 and n_devices > cand:
            rows = cand
            break
    return n_devices // rows, rows


def dryrun_data(dtype=torch.float32, device="cuda"):
    """x = linspace(−3, 3, N_OBS) and y = sin x."""
    x = torch.linspace(-3.0, 3.0, N_OBS, dtype=dtype, device=device)
    return x, torch.sin(x)


def nuts_logdensity(mesh, x, y):
    """Stage 1's log-density of q = (log lengthscale, log noise)."""

    def logdensity(q):
        k = with_lengthscale(SEKernel(), torch.exp(q[0]))
        lp = big_gp_logpdf(mesh, k, x, y, noise=torch.exp(q[1]), block_size=BLOCK, axis_name="rows")
        return lp - 0.5 * torch.sum(q * q)

    return logdensity


def nuts_stage(mesh, x, y, n_chains, chains=None):
    """Stage 1 on `mesh` for the chains `chains=(a, b, C)` of a run of
    `n_chains` (all of them by default): from q = 0, the pre-step log-density
    and gradient, then one NUTS transition.  Returns
    `(logps, grads, q, logp, info)` of those chains."""
    rows = Axis(mesh, "rows")
    a, b = chains[:2] if chains is not None else (0, n_chains)

    def agree(logp, grad):
        both = broadcast(torch.cat([logp[:, None], grad], dim=1), rows)
        return both[:, 0], both[:, 1:]

    step = nuts_kernel(nuts_logdensity(mesh, x, y), max_depth=NUTS_DEPTH,
                       chains=chains, sequential=True, agree=agree)
    d = 2
    qs = torch.zeros((b - a, d), dtype=x.dtype, device=x.device)
    with torch.no_grad():
        logps, grads = step.log_density(qs)
        eps = torch.tensor(NUTS_EPS, dtype=x.dtype, device=x.device)
        inv_mass = torch.ones((b - a, d), dtype=x.dtype, device=x.device)
        gen = generator(NUTS_SEED, _SAMPLE, 0, x.device)
        q2, logp2, _, info = step(gen, qs, logps, grads, eps, inv_mass)
    return logps, grads, q2, logp2, info


@gppp
def composite(t):
    """Stage 2's programme: f3 = v·SE + Matern32."""
    f1 = GP(t["v"] * SEKernel())
    f2 = GP(Matern32Kernel())
    return dict(f1=f1, f2=f2, f3=f1 + f2)


def _device(device_type):
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def dryrun_multichip(n_devices=None, device="cuda", dtype=torch.float32):
    """Run the four stages on a (chains × rows) grid of the job's ranks
    (`n_devices`, if given, must be the job's size); rank 0 prints the
    reference's summary line.

    Returns a dict of what the reference prints (the mesh, the chain count,
    N, the panel count, the depth, the first chain's log-density after the
    transition, the GPPP value and dlp/dv, the ring value and dlp/dl, the
    data mesh and −ELBO), whole on every rank, and besides: the transition's
    pre-step `logps` and `grads`, its `q`, `logp` and `accept_prob` (all
    chains), the GPPP `m1` and `v1`, the SVGP gradients, and each stage's
    kernel launches (`launches`) and collective calls (`collectives`)."""
    device_type = resolve_device(device).type
    made_group = not dist.is_initialized()
    multihost.ensure_group(device_type)
    try:
        return _dryrun(n_devices, device_type, dtype)
    finally:
        if made_group:
            dist.destroy_process_group()


def _dryrun(n_devices, device_type, dtype):
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"dryrun_multichip({n_devices}) in a job of {world} ranks: "
                         "start that many processes")
    chains_ax, rows = grid_shape(world)
    mesh = grid_mesh(chains_ax, rows, device_type=device_type)
    dev = _device(device_type)
    x, y = dryrun_data(dtype, dev)
    n_chains = 2 * chains_ax
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "chains": n_chains, "n": N_OBS,
           "nb": N_OBS // BLOCK, "depth": NUTS_DEPTH, "launches": {}, "collectives": {}}

    def reset():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        kern.reset_counters()
        coll.reset_counters()

    def read(stage):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["launches"][stage] = {k: c.total for k, c in kern.COUNTERS.items()}
        out["collectives"][stage] = {k: c.total for k, c in coll.COUNTERS.items()}

    # 1. a NUTS transition of the grid's chains, each a rows-sharded GP
    cax = Axis(mesh, "chains")
    a, b = cax.rows(n_chains)
    reset()
    logps, grads, q2, logp2, info = nuts_stage(mesh, x, y, n_chains, chains=(a, b, n_chains))
    whole = {k: all_gather(v, cax) for k, v in
             (("logps", logps), ("grads", grads), ("q", q2), ("logp", logp2),
              ("accept_prob", info.accept_prob))}
    read("nuts")
    if whole["q"].shape != (n_chains, 2):
        raise RuntimeError(f"dryrun_multichip: q has shape {tuple(whole['q'].shape)}")
    if not bool(torch.isfinite(whole["logp"]).all()):
        raise RuntimeError("non-finite logp in dryrun_multichip")
    out.update({k: v.cpu() for k, v in whole.items()})
    out["logp_first"] = whole["logp"][0].item()

    # 2. the composite programme through the sharded verbs
    xp = torch.linspace(-2.0, 2.0, 8, dtype=dtype, device=dev)
    reset()
    v = torch.tensor(1.2, dtype=dtype, device=dev, requires_grad=True)
    lp_g = sharded_logpdf(mesh, composite(dict(v=v))(GPPPInput("f3", x), 0.1), y, block_size=BLOCK)
    (g_v,) = torch.autograd.grad(lp_g, v)
    with torch.no_grad():
        fx = composite(dict(v=v.detach()))(GPPPInput("f3", x), 0.1)
        m1, v1 = sharded_posterior(mesh, fx, y, block_size=BLOCK).mean_and_var(GPPPInput("f1", xp))
    read("gppp")
    if not (math.isfinite(lp_g.item()) and bool(torch.isfinite(m1).all())):
        raise RuntimeError("non-finite sharded GPPP result in dryrun_multichip")
    out.update(gppp_lp=lp_g.item(), gppp_dlp_dv=g_v.item(), m1=m1.cpu(), v1=v1.cpu())

    # 3. the matrix-free ring over the same rows axis
    reset()
    ell = torch.tensor(1.0, dtype=dtype, device=dev, requires_grad=True)
    gen = torch.Generator(device=dev).manual_seed(2)
    lp_r = ring_gp_logpdf(mesh, with_lengthscale(SEKernel(), ell), shard_rows(mesh, x),
                          shard_rows(mesh, y), 0.1, gen, num_probes=4, lanczos_iters=6, maxiter=64)
    (g_r,) = torch.autograd.grad(lp_r, ell)
    read("ring")
    if not (math.isfinite(lp_r.item()) and math.isfinite(g_r.item())):
        raise RuntimeError("non-finite ring result in dryrun_multichip")
    out.update(ring_lp=lp_r.item(), ring_dlp_dl=g_r.item())

    # 4. a data-parallel SVGP step over every rank
    dmesh = data_mesh(device_type=device_type)
    f_sv = GP(with_lengthscale(SEKernel(), 1.0), gpc=GPC())
    z = torch.linspace(-3.0, 3.0, 16, dtype=dtype, device=dev)
    fz = f_sv(z, 1e-6)
    q0 = svgp_init(fz)
    y01 = (y > 0).to(dtype)
    reset()
    q_mu, q_sqrt = (t.detach().clone().requires_grad_(True) for t in (q0.q_mu, q0.q_sqrt))
    neg_elbo = -svgp_elbo_dp(dmesh, SVGP(fz, q_mu, q_sqrt), f_sv(x, 1e-6), y01, scale=1.0,
                             likelihood=BernoulliLikelihood())
    g_mu, g_sqrt = torch.autograd.grad(neg_elbo, (q_mu, q_sqrt))
    read("svgp")
    if not (math.isfinite(neg_elbo.item()) and bool(torch.isfinite(g_mu).all())):
        raise RuntimeError("non-finite SVGP step in dryrun_multichip")
    out.update(svgp_mesh=dict(zip(dmesh.mesh_dim_names, dmesh.shape)), neg_elbo=neg_elbo.item(),
               svgp_dq_mu=g_mu.cpu(), svgp_dq_sqrt=g_sqrt.cpu())

    if dist.get_rank() == 0:
        print(
            f"dryrun_multichip OK: mesh {out['mesh']}, "
            f"{n_chains} chains, N={N_OBS} rows-sharded (nb={N_OBS // BLOCK} "
            f"cyclic), depth={NUTS_DEPTH}, "
            f"logp[0]={out['logp_first']:.3f}, "
            f"gppp lp={out['gppp_lp']:.3f} dlp/dv={out['gppp_dlp_dv']:.3f}, "
            f"ring lp={out['ring_lp']:.3f} dlp/dl={out['ring_dlp_dl']:.3f}, "
            f"svgp-dp data mesh {out['svgp_mesh']} -elbo={out['neg_elbo']:.3f}",
            flush=True,
        )
    return out


__all__ = ["dryrun_multichip", "grid_shape", "dryrun_data", "nuts_logdensity", "nuts_stage",
           "composite"]

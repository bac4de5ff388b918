"""Gloo process groups of the PyTorch port on the CPU, for the
distributed tests (`tests/test_torch_parallel*.py`).

This module imports PyTorch and the port only, never JAX or the suite's
conftest, so a spawned rank starts in a few seconds.  `spawn(job, p,
inputs, tmp_path)` starts p processes of

    python tests/torch_dist_ranks.py <job> <rank> <p> <dir>

which join a gloo group through a `file://` store in `dir` (never a TCP
port: the suite runs six workers at once), run `JOBS[job](mesh, inputs)` on
one PyTorch thread and write their results; `spawn` returns them in rank
order.  The store, every collective and the join have a timeout: a rank
that deadlocks fails its test instead of hanging the suite.
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

REPO = Path(__file__).resolve().parent.parent
#: seconds a whole group may take, start-up included
JOIN_TIMEOUT = 240
#: seconds a store operation or a collective may wait for the other ranks
COLLECTIVE_TIMEOUT = 120


def spawn(job, p, inputs, tmp_path, timeout=JOIN_TIMEOUT):
    """Run `job` in p gloo ranks; the ranks' results in rank order."""
    return join(start(job, p, inputs, tmp_path, timeout))


def start(job, p, inputs, tmp_path, timeout=JOIN_TIMEOUT):
    """Start `job` in p gloo ranks and return at once: `join` waits for
    them, so the caller can work meanwhile."""
    d = Path(tmp_path) / f"{job}-p{p}"
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for r in range(p):
        log = open(d / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, __file__, job, str(r), str(p), str(d)],
                                       cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT),
                      log))
    return job, p, d, procs, timeout, time.monotonic()


def join(started):
    """The results of the ranks `start` began, in rank order."""
    job, p, d, procs, timeout, t_start = started
    deadline = t_start + timeout
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{job} at P={p} did not finish in {timeout} s:\n" + _logs(d, p))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    bad = [r for r, (proc, _) in enumerate(procs) if proc.returncode != 0]
    if bad:
        raise AssertionError(f"{job} at P={p}: ranks {bad} failed:\n" + _logs(d, p))
    out = []
    for r in range(p):
        with open(d / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _logs(d, p):
    return "\n".join(f"--- rank {r} ---\n" + (d / f"rank{r}.log").read_text()[-4000:]
                     for r in range(p))


def _np(tree):
    """Tensors to numpy, recursively."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# jobs: fn(inputs) -> picklable results of this rank
# ---------------------------------------------------------------------------

JOBS = {}


def job(fn):
    JOBS[fn.__name__] = fn
    return fn


def _rows_mesh():
    from stheno_tpu_torch.parallel import rows_mesh

    return rows_mesh(device_type="cpu")


def _slab(a, mesh):
    from stheno_tpu_torch.parallel import shard_rows

    return shard_rows(mesh, _t(a))


def _grad_wrt_slab(fn, K_loc):
    """fn(K_loc) (a scalar) and its gradient in this rank's slab."""
    K_loc = K_loc.detach().requires_grad_(True)
    val = fn(K_loc)
    (g,) = torch.autograd.grad(val, K_loc)
    return val.detach(), g


@job
def chol(inp):
    """The factors, solves, logdet, logpdf, relayout and FLOP counts."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from stheno_tpu_torch.parallel import cholesky as DC
    from stheno_tpu_torch.parallel.collectives import Axis, psum

    mesh = _rows_mesh()
    ax = Axis(mesh, "rows")
    B = inp["B"]
    K_loc = _slab(inp["K"], mesh)
    W_loc = _slab(inp["W"], mesh)
    out = {"rank": dist.get_rank(), "world": dist.get_world_size()}
    for name, fn in (("slab", DC.distributed_cholesky), ("cyclic", DC.distributed_cholesky_cyclic),
                     ("auto", DC.distributed_cholesky_auto)):
        val, g = _grad_wrt_slab(
            lambda K: psum(torch.sum(fn(mesh, K, block_size=B) * W_loc), ax), K_loc)
        out[f"L_{name}"] = fn(mesh, K_loc, block_size=B)
        out[f"f_{name}"], out[f"dK_{name}"] = val, g
    # one diagonal block per rank: the block as wide as the slab
    out["L_one_block"] = DC.distributed_cholesky(mesh, K_loc, block_size=K_loc.shape[0])
    L = out["L_slab"]
    Bm = _t(inp["Bm"])
    out["X"] = DC.distributed_solve_lower(mesh, L, _slab(inp["Bm"], mesh), block_size=B)
    out["x_vec"] = DC.distributed_solve_lower(mesh, L, _slab(inp["v"], mesh), block_size=B)
    out["Xt"] = DC.distributed_solve_upper_T(mesh, L, Bm, block_size=B)
    out["S"] = DC.distributed_chol_solve(mesh, L, _slab(inp["Bm"], mesh), block_size=B)
    out["Lv"] = DC.distributed_lower_matvec(mesh, L, _t(inp["v"]))
    out["logdet"] = DC.distributed_logdet_chol(mesh, L)
    out["mvn"] = DC.distributed_mvn_logpdf(mesh, K_loc, _slab(inp["m"], mesh),
                                           _slab(inp["v"], mesh), block_size=B)
    # the solves' gradients in the sharded factor and right-hand side
    val, gL = _grad_wrt_slab(
        lambda Ls: torch.sum(DC.distributed_chol_solve(mesh, Ls, _slab(inp["Bm"], mesh), block_size=B)
                             * Bm), L)
    out["f_solve"], out["dL_solve"] = val, gL
    # the relayout, matrices and vectors, for several blocks per rank
    for Br in inp["relayout_blocks"]:
        Mc = DC.to_cyclic(mesh, _slab(inp["M"], mesh), Br)
        out[f"cyc_{Br}"] = Mc
        out[f"back_{Br}"] = DC.from_cyclic(mesh, Mc, Br)
        out[f"cycv_{Br}"] = DC.to_cyclic(mesh, _slab(inp["v"], mesh), Br)
    # per-rank GEMM FLOPs of the two layouts at a larger N
    Kf = _slab(inp["K_flops"], mesh)
    for name, fn in (("slab", DC.distributed_cholesky), ("cyclic", DC.distributed_cholesky_cyclic)):
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            fn(mesh, Kf, block_size=inp["B_flops"])
        out[f"flops_{name}"] = fc.get_total_flops()
    try:
        DC.distributed_cholesky_auto(mesh, _slab(inp["K_bad"], mesh), block_size=B)
        out["bad_shape"] = "no error"
    except ValueError as e:
        out["bad_shape"] = str(e)
    out.update(_big(mesh, inp))
    return out


def _big(mesh, inp):
    """The sharded kernel matrix, its matvec, and `big_gp_logpdf` with its
    gradient in (log ℓ, noise) on every rank, and its GEMM FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    from stheno_tpu_torch.kernels import SEKernel, with_lengthscale
    from stheno_tpu_torch.parallel import big_gp_logpdf, sharded_kernelmatrix, sharded_matvec

    x, y = _t(inp["x"]), _t(inp["y"])
    out = {"Kx": sharded_kernelmatrix(mesh, SEKernel(), x, noise=0.1)}
    out["Kv"] = sharded_matvec(mesh, out["Kx"], _t(inp["v"]))
    log_l = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    noise = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    k = with_lengthscale(SEKernel(), torch.exp(log_l))
    lp = big_gp_logpdf(mesh, k, x, y, noise, block_size=inp["B_big"])
    out["big_lp"] = lp.detach()
    out["big_grad"] = torch.stack(torch.autograd.grad(lp, (log_l, noise)))
    xf = _t(inp["x_flops"])
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        big_gp_logpdf(mesh, SEKernel(), xf, torch.sin(xf), 0.1, block_size=inp["B_flops"])
    out["flops_big"] = fc.get_total_flops()
    return out


def composite(theta):
    """The reference tests' programme: f3 = v·SE(·/l) + Matern32."""
    from stheno_tpu_torch import GP, Matern32Kernel, SEKernel, gppp, with_lengthscale

    @gppp
    def build(t):
        f1 = GP(t["v"] * with_lengthscale(SEKernel(), t["l"]))
        f2 = GP(Matern32Kernel())
        return dict(f1=f1, f2=f2, f3=f1 + f2)

    return build(theta)


class _LargestOutput(TorchDispatchMode):
    """Records the most elements any one op's output had."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree.tree_leaves(out):
            if torch.is_tensor(t):
                self.most = max(self.most, t.numel())
        return out


@job
def gppp(inp):
    """The sharded GPPP verbs on the composite programme."""
    from stheno_tpu_torch import BlockData, FullNoise, GPPPInput
    from stheno_tpu_torch.parallel import (
        sharded_chol,
        sharded_cov,
        sharded_logpdf,
        sharded_posterior,
        sharded_rand,
    )

    mesh = _rows_mesh()
    B = inp["B"]
    x, y, xp = _t(inp["x"]), _t(inp["y"]), _t(inp["xp"])
    theta = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
             for k, v in inp["theta"].items()}
    fx = composite(theta)(GPPPInput("f3", x), 0.1)
    lp = sharded_logpdf(mesh, fx, y, block_size=B)
    grads = torch.autograd.grad(lp, list(theta.values()))
    out = {"lp": lp.detach(), "grad": torch.stack(grads)}
    with torch.no_grad():
        f = composite({k: v.detach() for k, v in theta.items()})
        post = sharded_posterior(mesh, f(GPPPInput("f3", x), 0.1), y, block_size=B)
        xq = GPPPInput("f1", xp)
        out["post_m"], out["post_v"] = post.mean_and_var(xq)
        out["post_C"] = post.cov(xq)
        out["post_mb"] = post.mean(BlockData(GPPPInput("f1", xp), GPPPInput("f2", xp)))
        xq2 = GPPPInput("f2", xp[::2])
        out["post_C2"], out["post_v2"] = post.cov2(xq, xq), post.var2(xq2, xq2)
        out["chol"] = sharded_chol(mesh, f(GPPPInput("f3", x), 0.1), block_size=B)
        # a joint query whose blocks straddle the ranks' rows, under a
        # per-point noise and a dense one
        xb = BlockData(GPPPInput("f1", _t(inp["x1"])), GPPPInput("f3", _t(inp["x2"])))
        out["cov_block"] = sharded_cov(mesh, f(xb, _t(inp["noise_vec"])))
        out["cov_full"] = sharded_cov(mesh, f(xb, FullNoise(_t(inp["noise_full"]))))
        # the same query as (name, point) pairs, which a GPPP groups by name
        pairs = ([("f1", p) for p in _t(inp["x1"])] + [("f3", p) for p in _t(inp["x2"])])
        out["cov_pairs"] = sharded_cov(mesh, f(pairs, _t(inp["noise_vec"])))
        fr = f(GPPPInput("f3", _t(inp["x_rand"])), 0.1)
        out["draws"] = torch.stack([
            sharded_rand(torch.Generator().manual_seed(s), mesh, fr, block_size=B)
            for s in range(inp["num_draws"])])
        out["draw_again"] = sharded_rand(torch.Generator().manual_seed(0), mesh, fr, block_size=B)
    # no rank makes an N×N tensor, forward or backward
    theta2 = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
    xl = _t(inp["x_large"])
    with _LargestOutput() as rec:
        lp2 = sharded_logpdf(mesh, composite(theta2)(GPPPInput("f3", xl), 0.1), torch.sin(xl),
                             block_size=inp["B_large"])
        torch.autograd.grad(lp2, list(theta2.values()))
    out["largest"] = rec.most
    return out


def _ring_kernel(v=1.7, ell=0.9):
    from stheno_tpu_torch.kernels import SEKernel, with_lengthscale

    return v * with_lengthscale(SEKernel(), ell)


@job
def ring(inp):
    """The ring matvec, CG solves, posterior marginals and the stochastic
    logpdf with its gradients, on each rank's shard."""
    from stheno_tpu_torch.parallel import ring_gp_solve, ring_matvec, ring_posterior_mean_var
    from stheno_tpu_torch.parallel.ring import ring_gp_logpdf

    mesh = _rows_mesh()
    x, v = _slab(inp["x"], mesh), _slab(inp["v"], mesh)
    out = {"mv": ring_matvec(mesh, _ring_kernel(), x, v, noise=0.3)}
    out["mv2"] = ring_matvec(mesh, _ring_kernel(), _slab(inp["x2d"], mesh), _slab(inp["V"], mesh),
                             noise=0.1)
    ell = torch.tensor(0.9, dtype=torch.float64, requires_grad=True)
    q = psum_dot(mesh, v, ring_matvec(mesh, _ring_kernel(ell=ell), x, v, noise=0.2))
    out["qform"], out["dqform"] = q.detach(), torch.autograd.grad(q, ell)[0]
    y = _slab(inp["y"], mesh)
    out["solve"], out["solve_iters"] = ring_gp_solve(mesh, _ring_kernel(), x, y, 0.2, tol=1e-12)
    out["post_m"], out["post_v"], out["post_iters"] = ring_posterior_mean_var(
        mesh, _ring_kernel(), x, y, 0.1, _t(inp["xs"]), tol=1e-12)
    gen = torch.Generator().manual_seed(0)
    out["lp"] = ring_gp_logpdf(mesh, _ring_kernel(), x, y, 0.2, gen, num_probes=32,
                               lanczos_iters=30)
    yy = y.detach().requires_grad_(True)
    lp = ring_gp_logpdf(mesh, _ring_kernel(), x, yy, 0.2, torch.Generator().manual_seed(0),
                        num_probes=4, lanczos_iters=8)
    out["ygrad"] = torch.autograd.grad(lp, yy)[0]
    # the hyperparameter gradient (Hutchinson) on a 96-point set
    params = {k: torch.tensor(val, dtype=torch.float64, requires_grad=True)
              for k, val in dict(v=1.7, l=0.9, noise=0.2).items()}
    lp = ring_gp_logpdf(mesh, _ring_kernel(params["v"], params["l"]), _slab(inp["x96"], mesh),
                        _slab(inp["y96"], mesh), params["noise"], torch.Generator().manual_seed(0),
                        num_probes=48, lanczos_iters=20)
    out["hgrad"] = torch.stack(torch.autograd.grad(lp, list(params.values())))
    return out


def psum_dot(mesh, a, b):
    from stheno_tpu_torch.parallel.collectives import Axis, psum

    return psum(torch.dot(a, b), Axis(mesh, "rows"))


@job
def misc(inp):
    """Data-parallel SVGP, the sharded samplers, the multi-process helpers."""
    out = {}
    out.update(_svgp(inp))
    out.update(_chains(inp))
    out.update(_multihost(inp))
    return out


def _svgp(inp):
    from stheno_tpu_torch import GP, GPC, GPPPInput, SEKernel, with_lengthscale
    from stheno_tpu_torch.inference import SVGP, BernoulliLikelihood, svgp_elbo, svgp_init
    from stheno_tpu_torch.parallel import data_mesh, shard_batch, svgp_elbo_dp

    mesh = data_mesh(device_type="cpu")
    x, y, z = _t(inp["svgp_x"]), _t(inp["svgp_y"]), _t(inp["svgp_z"])
    q0 = svgp_init(composite(inp["theta0"])(GPPPInput("f3", z), 1e-9))
    out = {}
    for dp in (True, False):
        params = {k: _t(v).clone().requires_grad_(True) for k, v in inp["svgp_params"].items()}
        params["q_mu"] = (q0.q_mu + 0.1).requires_grad_(True)
        params["q_sqrt"] = (q0.q_sqrt + 0.05).requires_grad_(True)
        f = composite(dict(v=params["v"], l=params["l"]))
        q = SVGP(f(GPPPInput("f3", z), 1e-9), params["q_mu"], params["q_sqrt"])
        fx = f(GPPPInput("f3", x), params["noise"])
        val = svgp_elbo_dp(mesh, q, fx, y, scale=2.5) if dp else svgp_elbo(q, fx, y, scale=2.5)
        grads = torch.autograd.grad(val, list(params.values()))
        tag = "dp" if dp else "sd"
        out[f"svgp_{tag}"] = val.detach()
        out.update({f"svgp_{tag}_d{k}": g for k, g in zip(params, grads)})
    # one Adam step with a Bernoulli likelihood, sharded and not
    f = GP(1.3 * with_lengthscale(SEKernel(), 0.9), gpc=GPC())
    xb, yb, zb = _t(inp["bern_x"]), _t(inp["bern_y"]), _t(inp["bern_z"])
    fz = f(zb, 1e-9)
    q0 = svgp_init(fz)
    lik = BernoulliLikelihood()
    for dp in (True, False):
        params = [q0.q_mu.clone().requires_grad_(True), q0.q_sqrt.clone().requires_grad_(True)]
        opt = torch.optim.Adam(params, lr=0.1)
        q = SVGP(fz, *params)
        loss = (-svgp_elbo_dp(mesh, q, f(xb, 1e-9), yb, likelihood=lik) if dp
                else -svgp_elbo(q, f(xb, 1e-9), yb, likelihood=lik))
        loss.backward()
        opt.step()
        tag = "dp" if dp else "sd"
        out[f"bern_{tag}"], out[f"bern_{tag}_q_mu"] = loss.detach(), params[0].detach().clone()
    out["batch_rows"] = shard_batch(mesh, xb)
    return out


def _chains(inp):
    from stheno_tpu_torch import entry
    from stheno_tpu_torch.inference import run_nuts, run_smc
    from stheno_tpu_torch.parallel import chains_mesh, run_nuts_sharded, run_smc_sharded

    mesh = chains_mesh(device_type="cpu")
    out = {}

    def logp(q):
        return -0.5 * torch.sum(q**2)

    init = torch.zeros(3, dtype=torch.float64)
    kw = dict(num_warmup=30, num_samples=20, num_chains=4)
    out["nuts_sharded"], info = run_nuts_sharded(0, logp, init, mesh, **kw)
    out["nuts_sharded_eps"] = info.step_size
    out["nuts"], info = run_nuts(0, logp, init, **kw)
    out["nuts_eps"] = info.step_size
    # a GP log-density over hyperparameters (kernel 1 batched over chains)
    data = entry.nuts_data(20, device="cpu")
    ld, theta0, _ = entry.nuts_logdensity(data)
    kw = dict(num_warmup=10, num_samples=6, num_chains=4, max_depth=5)
    out["gp_nuts_sharded"], _ = run_nuts_sharded(3, ld, theta0, mesh, **kw)
    out["gp_nuts"], _ = run_nuts(3, ld, theta0, **kw)

    def loglike(q):
        return -0.5 * torch.sum((q - 1.0) ** 2)

    def logprior(q):
        return -0.5 * torch.sum(q**2)

    parts = _t(inp["smc_init"])
    kw = dict(num_mcmc=2, hmc_step_size=0.5, hmc_num_steps=4)
    for tag, res in (("smc_sharded", run_smc_sharded(1, loglike, logprior, parts, mesh, **kw)),
                     ("smc", run_smc(1, loglike, logprior, parts, **kw))):
        out[tag] = dict(particles=res.particles, log_evidence=res.log_evidence,
                        num_stages=res.num_stages, beta_history=res.beta_history)
    return out


def _multihost(inp):
    import torch.distributed as dist

    from stheno_tpu_torch.inference.checkpoint import load_checkpoint
    from stheno_tpu_torch.parallel import grid_mesh, multihost
    from stheno_tpu_torch.parallel.collectives import Axis, psum

    multihost.initialize("file:///nonexistent/never-used", 99, 0, device_type="cpu")  # a no-op now
    p = dist.get_world_size()
    grid = grid_mesh(2, p // 2, device_type="cpu")
    rows = Axis(grid, "rows")
    out = {"grid_shape": tuple(grid.shape), "host0": multihost.is_host0(),
           "rows_sum": psum(torch.tensor(float(dist.get_rank())), rows).item(),
           "chains_index": Axis(grid, "chains").rank}
    state = {"a": torch.arange(3.0) + 1.0}
    multihost.save_on_host0(inp["ckpt_dir"], state, step=7)
    dist.barrier()
    out["ckpt"] = load_checkpoint(inp["ckpt_dir"], state)["a"]
    return out


@job
def precision(inp):
    """The distributed factor (slab and cyclic) and the distributed solve,
    f32, value and slab gradient at 'highest' and at 'high'; how many
    products ran below 'highest'."""
    from stheno_tpu_torch import config
    from stheno_tpu_torch.ops import blocked_cholesky as bc
    from stheno_tpu_torch.parallel import cholesky as DC
    from stheno_tpu_torch.parallel.collectives import Axis, psum

    mesh = _rows_mesh()
    ax = Axis(mesh, "rows")
    B = inp["B"]
    f32 = lambda a: _t(a).float()  # noqa: E731
    K_loc = _slab(inp["K"], mesh).float()
    W_loc = _slab(inp["W"], mesh).float()
    Bm = f32(inp["Bm"])
    low = []
    real = bc._products

    def counted(a, b, prec):
        low.append(prec)
        return real(a, b, prec)

    bc._products = counted
    out = {}
    try:
        for prec in ("highest", "high"):
            with config.gemm_precision(prec):
                for name, fn in (("slab", DC.distributed_cholesky),
                                 ("cyclic", DC.distributed_cholesky_cyclic)):
                    val, g = _grad_wrt_slab(
                        lambda K, fn=fn: psum(torch.sum(fn(mesh, K, block_size=B) * W_loc), ax), K_loc)
                    out[f"f_{name}_{prec}"], out[f"g_{name}_{prec}"] = val, g
                L = DC.distributed_cholesky(mesh, K_loc, block_size=B).detach()
                val, g = _grad_wrt_slab(
                    lambda Ls: torch.sum(DC.distributed_chol_solve(
                        mesh, Ls, _slab(inp["Bm"], mesh).float(), block_size=B) * Bm), L)
                out[f"f_solve_{prec}"], out[f"g_solve_{prec}"] = val, g
    finally:
        bc._products = real
    out["low_precision_products"] = len(low)
    return out


@job
def examples(inp):
    """The three entry examples at their fast sizes."""
    from stheno_tpu_torch import entry

    return {"big_n_sharded": entry.big_n_sharded_example(fast=True, device="cpu"),
            "matrix_free": entry.matrix_free_example(fast=True, device="cpu"),
            "svgp_data_parallel": entry.svgp_data_parallel_example(device="cpu", **inp["svgp"])}


@job
def multichip(inp):
    """`multichip.dryrun_multichip` on the job's grid, and the transition
    over every chain in this rank's rows group (the bit-for-bit reference
    of the grid's)."""
    import torch.distributed as dist

    from stheno_tpu_torch import multichip as mc
    from stheno_tpu_torch.parallel import grid_mesh

    out = mc.dryrun_multichip(device="cpu", dtype=torch.float64)
    mesh = grid_mesh(*mc.grid_shape(dist.get_world_size()), device_type="cpu")
    x, y = mc.dryrun_data(torch.float64, "cpu")
    _, _, q, logp, info = mc.nuts_stage(mesh, x, y, out["chains"])
    out.update(ref_q=q, ref_logp=logp, ref_accept_prob=info.accept_prob)
    return out


def _main(argv):
    name, rank, p, d = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    from stheno_tpu_torch.parallel import multihost

    multihost.initialize(f"file://{d}/store", num_processes=p, process_id=rank, device_type="cpu",
                         timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    with open(d / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    out = JOBS[name](inputs)
    with open(d / f"out{rank}.pkl", "wb") as f:
        pickle.dump(_np(out), f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])

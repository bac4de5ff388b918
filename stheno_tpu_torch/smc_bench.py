"""SMC: evidence accuracy and particle throughput (counterpart of
`scripts/smc_bench.py`; a measurement tool, not a test).

Two workloads, each timed on the host clock around calls that end in a
copy to the host, with null probes (a tiny launch, a synchronize,
`.item()`) before and after:

1. `analytic`: a linear-Gaussian model whose evidence is closed-form,
       loglike(q) = log N(y0; q, σ² I_d),  prior q ~ N(0, I_d)
       ⇒ log Z = log N(y0; 0, (1 + σ²) I_d),
   so the estimator's error is read directly (O(1/√P)); no GP, no kernel.
2. `gp`: the model-evidence workload (`entry.smc_data`, `smc_loglike`) at
   N points: the 3-hyperparameter GP likelihood, each evaluation one
   batched kernel-1 launch over the particles and a batched factor
   (`torch.linalg`); particle-stage updates a second
   (P · stages / seconds, a stage being `num_mcmc` HMC sweeps of all P).

    python -m stheno_tpu_torch.smc_bench [analytic] [gp] [--n 1024]
        [--p 64] [--p-analytic 4096] [--segment S] [--seeds 2]
        [--device cuda|cpu]

Prints one JSON line per workload on stdout, progress on stderr.  Run i
is seeded from (5, i); `--segment S` runs the gp workload S stages a call
(`smc_init` → `smc_segment` → `smc_result`), bit for bit the fused run.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

DT = torch.float32
#: the analytic model: dimension, likelihood variance, observation
D_ANALYTIC, SIGMA2 = 3, 0.5
Y0 = (0.7, -1.1, 0.4)
#: the gp workload's settings, and the stage cap of its segmented runs
GP_KW = dict(num_mcmc=3, hmc_step_size=0.25, hmc_num_steps=8)
MAX_STAGES = 50


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m stheno_tpu_torch.smc_bench",
                                 description="SMC evidence accuracy and particle throughput.")
    ap.add_argument("which", nargs="*", default=[], help="analytic and/or gp (default both)")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--p", type=int, default=64)
    ap.add_argument("--p-analytic", type=int, default=4096)
    ap.add_argument("--segment", type=int, default=0,
                    help="gp workload: tempering stages per call (0 = the whole run in one "
                         "call); the run does not depend on it")
    ap.add_argument("--seeds", type=int, default=2,
                    help="gp workload: timed runs (also the basis of the log-Z spread)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    bad = set(args.which) - {"analytic", "gp"}
    if bad:
        ap.error(f"unknown workload(s) {sorted(bad)}: choose analytic and/or gp")
    return args


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def null_probe(dev, label):
    """Seconds of one tiny launch, a synchronize and `.item()`."""
    a = torch.arange(8.0, device=dev)

    def null(i):
        t = torch.sum(a) + i * 1e-7
        sync(dev)
        return t.item()

    null(0)
    t0 = time.perf_counter()
    for i in range(1, 7):
        null(i)
    s = (time.perf_counter() - t0) / 6
    log(f"null({label}): {s * 1e3:.3f} ms")
    return s


def normal_particles(p, d, scale, dtype, device, seed=1):
    """`scale` × a standard-normal (p, d) draw from a seeded CPU
    `torch.Generator`, on `device`: the same particles on every device."""
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn((p, d), generator=g, dtype=torch.float64)).to(dtype=dtype, device=device)


def analytic_problem(p, dtype=DT, device="cuda"):
    """(loglike, logprior, init particles, true log Z) of the analytic model."""
    d = D_ANALYTIC
    y0 = torch.tensor(Y0, dtype=dtype, device=device)
    y0n = np.asarray(Y0)
    lz_true = float(-0.5 * (d * np.log(2 * np.pi * (1 + SIGMA2)) + float(y0n @ y0n) / (1 + SIGMA2)))
    log_2pi_s2 = math.log(2 * math.pi * SIGMA2)

    def loglike(q):
        r = q - y0
        return -0.5 * (d * log_2pi_s2 + torch.sum(r * r) / SIGMA2)

    def logprior(q):
        return -0.5 * (torch.sum(q * q) + d * math.log(2 * math.pi))

    return loglike, logprior, normal_particles(p, d, 1.0, dtype, device), lz_true


def gp_problem(n, p, dtype=DT, device="cuda"):
    """(loglike, logprior, init particles, data) of the gp workload: x
    sorted uniform on [−4, 4] from numpy seed 3, y a numpy draw of
    1.5·SE(·/1.2) under noise 0.1, particles 0.3 × a normal draw."""
    from stheno_tpu_torch import entry

    data = entry.smc_data(n, dtype, device, seed=3)
    return (entry.smc_loglike(entry.SMC_BUILDS["SE"], data), entry.smc_logprior,
            normal_particles(p, 3, 0.3, dtype, device), data)


def run_gp(problem, i, segment=0):
    """Run i of the gp workload, fused or `segment` stages a call: returns
    (log Z, stages, particles on the host, seconds, seconds of each call)."""
    from stheno_tpu_torch.inference import run_smc, smc_finished, smc_init, smc_result, smc_segment
    from stheno_tpu_torch.inference.hmc import fold_in

    loglike, logprior, init, _ = problem
    dev = init.device
    seed = fold_in(5, i)
    sync(dev)
    t0 = time.perf_counter()
    seg_times = []
    if segment > 0:
        state = smc_init(loglike, logprior, init, max_stages=MAX_STAGES)
        while not smc_finished(state, MAX_STAGES):
            ts = time.perf_counter()
            state = smc_segment(seed, loglike, logprior, init, state, segment,
                                max_stages=MAX_STAGES, **GP_KW)
            sync(dev)
            seg_times.append(time.perf_counter() - ts)
            log(f"  seg {len(seg_times)}: {seg_times[-1]:.2f}s beta={state.beta.item():.4f} "
                f"step={int(state.step)}")
        res = smc_result(state, init)
    else:
        res = run_smc(seed, loglike, logprior, init, max_stages=MAX_STAGES, **GP_KW)
    parts = res.particles.cpu().numpy()  # the copy to the host ends the run
    return (res.log_evidence.item(), int(res.num_stages), parts, time.perf_counter() - t0,
            seg_times)


def main(argv=None):
    args = parse(argv)
    from stheno_tpu_torch.convert import resolve_device
    from stheno_tpu_torch.inference import run_smc
    from stheno_tpu_torch.inference.hmc import fold_in

    dev = resolve_device(args.device)
    want = set(args.which) or {"analytic", "gp"}
    log(f"device: {dev}")
    if dev.type == "cuda":
        from stheno_tpu_torch import cuda as kern

        kern.build_all()
    rows = []

    if "analytic" in want:
        loglike, logprior, init, lz_true = analytic_problem(args.p_analytic, DT, dev)

        def run(i):
            res = run_smc(fold_in(5, i), loglike, logprior, init, num_mcmc=3, hmc_step_size=0.4,
                          hmc_num_steps=8)
            return res.log_evidence.item(), int(res.num_stages)

        nb = null_probe(dev, "before")
        t0 = time.perf_counter()
        run(0)
        log(f"analytic first run {time.perf_counter() - t0:.1f}s")
        reps, errs = 3, []
        t0 = time.perf_counter()
        for i in range(1, reps + 1):
            lz, stages = run(i)
            errs.append(lz - lz_true)
        dt_s = (time.perf_counter() - t0) / reps
        na = null_probe(dev, "after")
        rows.append({
            "metric": "smc_evidence_error_analytic",
            "particles": args.p_analytic, "d": D_ANALYTIC,
            "log_z_true": round(lz_true, 4),
            "log_z_err_mean": round(float(np.mean(errs)), 4),
            "log_z_err_abs_max": round(float(np.max(np.abs(errs))), 4),
            "stages": stages, "wall_s": round(dt_s, 3),
            "null_ms": round(5e2 * (nb + na), 1),
        })
        log(f"analytic: logZ err {errs} (truth {lz_true:.3f})")

    if "gp" in want:
        N, P_ = args.n, args.p
        problem = gp_problem(N, P_, DT, dev)
        nb = null_probe(dev, "before")
        lz, stages, _, wall, _ = run_gp(problem, 0, args.segment)
        log(f"gp first run {wall:.1f}s logZ={lz:.2f} stages={stages}")
        lzs, walls, seg_times = [], [], []
        for i in range(1, args.seeds + 1):
            lz, stages, p_host, wall, segs = run_gp(problem, i, args.segment)
            lzs.append(lz)
            walls.append(wall)
            seg_times += segs
        dt_s = float(np.mean(walls))
        na = null_probe(dev, "after")
        med = np.exp(np.median(p_host, axis=0))
        row = {
            "metric": f"smc_gp_evidence_N{N}",
            "n": N, "particles": P_, "stages": stages,
            "num_mcmc": GP_KW["num_mcmc"], "hmc_steps": GP_KW["hmc_num_steps"],
            "wall_s": round(dt_s, 2),
            "particle_stage_updates_per_s": round(P_ * stages / dt_s, 1),
            "loglike_evals_per_s": round(
                P_ * stages * (1 + GP_KW["num_mcmc"] * GP_KW["hmc_num_steps"]) / dt_s, 1),
            "log_z": round(float(lzs[-1]), 2),
            "log_z_seed_spread": round(float(np.ptp(lzs)), 3),
            "posterior_medians_v_l_noise": [round(float(v), 3) for v in med],
            "null_ms": round(5e2 * (nb + na), 1),
        }
        if args.segment > 0:
            row["segment_stages"] = args.segment
            row["seg_s_median"] = round(float(np.median(seg_times)), 2)
        rows.append(row)
        log(f"gp: medians v={med[0]:.2f} l={med[1]:.2f} noise={med[2]:.3f} "
            f"(truth 1.5, 1.2, 0.1)")

    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


if __name__ == "__main__":
    main()

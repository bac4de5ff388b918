"""NUTS ESS/s at an exact-GP likelihood's cost (counterpart of
`scripts/nuts_bench.py`; a measurement tool, not a test).

The getting-started posterior of (v, l, noise) under `f = GP(v·SE(·/l))`
with an N-point exact-GP likelihood per chain (`entry.nuts_data`,
`entry.nuts_logdensity`): each leapfrog pays one batched kernel-1 launch
and one batched O(N³/3) factor for all chains.

    python -m stheno_tpu_torch.nuts_bench [--n 2048] [--chains 16]
        [--warmup 300] [--samples 500] [--max-depth 8] [--segment S]
        [--warmup-segment W] [--single-pass] [--precision P]
        [--chain-batches B] [--batch-offset O] [--save-draws out.npz]
        [--device cuda|cpu]

Prints one JSON line on stdout (the reference's keys and `device`: the
card's name and power limit as `nvidia-smi` gives them); progress on
stderr.  Timing is sampling-only: the CUDA kernels are built and the
libraries warmed by one batched evaluation before any timed window;
warmup runs first, timed apart and excluded; the sampling window starts
after a synchronize and ends with the draws' copy to the host.  The null
probe (a tiny launch, a synchronize, `.item()`, six times before and after)
estimates the fixed cost of a call, so `overhead = n_sampling_calls × null`.

`--segment S` takes the draws S at a time (`run_nuts(resume_state=...,
sample_offset=...)`), warmup W iterations at a time: the draws equal the
unsegmented run's bit for bit.  Chain batch b is seeded from
(2, batch_offset + b), so `--chain-batches 2` equals two runs with
`--batch-offset 0` and `1`, whose `--save-draws` files
`python -m stheno_tpu_torch.nuts_pool` pools.  ESS and R̂ are those of
`inference.diagnostics` on the log of the constrained draws.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

NAMES = ("v", "l", "noise")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m stheno_tpu_torch.nuts_bench",
                                 description="NUTS ESS/s at an exact-GP likelihood's cost.")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--segment", type=int, default=0,
                    help="draws per sampling call (0 = all draws in one call); the draws do "
                         "not depend on it")
    ap.add_argument("--precision", default=None,
                    help="GEMM precision of the whole run ('highest', 'high', 'default'); "
                         "default: the samplers' 'auto' policy")
    ap.add_argument("--chain-batches", type=int, default=1, dest="chain_batches",
                    help="run B batches of --chains chains one after another and pool their "
                         "draws for R-hat and ESS; the time sums over the batches")
    ap.add_argument("--batch-offset", type=int, default=0, dest="batch_offset",
                    help="offset of the chain batches' seeds: each batch can run as a process "
                         "of its own (--batch-offset b), pooled by nuts_pool")
    ap.add_argument("--save-draws", default=None, dest="save_draws",
                    help="write the constrained draws and the timings to this .npz "
                         "(the input of nuts_pool)")
    ap.add_argument("--warmup-segment", type=int, default=0, dest="warmup_segment",
                    help="warmup iterations per call in segmented mode (default "
                         "max(--segment, 10))")
    ap.add_argument("--single-pass", action="store_true", dest="single_pass",
                    help="segmented mode: the steady time from the first pass's median "
                         "segment instead of a second full pass")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def card_line(dev):
    """The card's name and power limit as `nvidia-smi` prints them; 'cpu'
    on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[dev.index or 0]


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def null_probe(x, dev, label):
    """Seconds of one tiny launch, a synchronize and `.item()`: the mean of
    six after one unmeasured."""

    def null(i):
        t = torch.sum(x[:8]) + i * 1e-7
        sync(dev)
        return t.item()

    null(0)
    t0 = time.perf_counter()
    for i in range(1, 7):
        null(i)
    s = (time.perf_counter() - t0) / 6
    log(f"null({label}): {s * 1e3:.3f} ms")
    return s


def warm_up(logdensity, theta0, chains, dev):
    """Build the CUDA kernels and warm the libraries: one batched
    evaluation of the log-density and its gradient.  Returns its seconds."""
    from stheno_tpu_torch.inference.hmc import BatchedLogDensity

    t0 = time.perf_counter()
    if dev.type == "cuda":
        from stheno_tpu_torch import cuda as kern

        kern.build_all()
    with torch.no_grad():
        BatchedLogDensity(logdensity)(theta0.expand(chains, -1).clone())
    sync(dev)
    return time.perf_counter() - t0


def main(argv=None):
    args = parse(argv)
    from stheno_tpu_torch import entry
    from stheno_tpu_torch.convert import resolve_device
    from stheno_tpu_torch.inference import (
        effective_sample_size,
        nuts_warmup,
        potential_scale_reduction,
        run_nuts,
        warmup_result,
    )
    from stheno_tpu_torch.inference.hmc import fold_in

    dev = resolve_device(args.device)
    N = args.n
    log(f"device: {dev}  N={N}  chains={args.chains}  warmup={args.warmup}  "
        f"samples={args.samples}")
    x, y = entry.nuts_data(N, torch.float32, dev)
    logdensity, theta0, unflatten = entry.nuts_logdensity((x, y))
    # an explicit --precision goes to the samplers (and overrides 'auto')
    prec = args.precision if args.precision else "auto"
    log(f"precision policy: {prec}")
    common = dict(num_chains=args.chains, max_depth=args.max_depth, precision=prec)
    log(f"build + warm-up: {warm_up(logdensity, theta0, args.chains, dev):.1f}s")

    def host(t):
        return t.cpu().numpy()  # the copy to the host ends the window

    def warm_fused(seed):
        return warmup_result(nuts_warmup(seed, logdensity, theta0, num_warmup=args.warmup, **common))

    def warm_segmented(seed):
        # iterations past the schedule are no-ops, so W need not divide it
        W = args.warmup_segment or max(args.segment, 10)
        state = nuts_warmup(seed, logdensity, theta0, num_warmup=args.warmup,
                            segment=(0, min(W, args.warmup)), **common)
        a = min(W, args.warmup)
        t0 = time.perf_counter()
        while a < args.warmup:
            state = nuts_warmup(seed, logdensity, theta0, num_warmup=args.warmup,
                                segment=(a, a + W), state=state, **common)
            a += W
            log(f"  warmup {min(a, args.warmup)}/{args.warmup} "
                f"({time.perf_counter() - t0:.1f}s since the first segment)")
        return warmup_result(state)

    def full_run(seed):
        """(draws, divergences, sampling seconds, warmup seconds, calls,
        seconds of each call) of one chain batch."""
        sync(dev)
        t0 = time.perf_counter()
        state = (warm_segmented if args.segment > 0 else warm_fused)(seed)
        sync(dev)
        t_warm = time.perf_counter() - t0
        S = args.segment if args.segment > 0 else args.samples
        chunks, divs, seg_times = [], [], []
        t0 = time.perf_counter()
        off = 0
        while off < args.samples:
            k = min(S, args.samples - off)
            ts = time.perf_counter()
            smp, info, state = run_nuts(seed, logdensity, theta0, num_samples=k, resume_state=state,
                                        return_state=True, sample_offset=off, check_rhat=False,
                                        **common)
            chunks.append(host(smp))
            divs.append(host(info.diverging))
            seg_times.append(time.perf_counter() - ts)
            off += k
            if args.segment > 0:
                log(f"  seg off={off - k:4d}: {seg_times[-1]:.2f}s")
        dt = time.perf_counter() - t0
        return (np.concatenate(chunks, axis=1), np.concatenate(divs, axis=1), dt, t_warm,
                len(seg_times), seg_times)

    def batches():
        parts, divs, dt, t_warm, n_calls, seg = [], [], 0.0, 0.0, 0, []
        for b in range(args.chain_batches):
            sb, db, dtb, twb, ncb, segb = full_run(fold_in(2, args.batch_offset + b))
            parts.append(sb)
            divs.append(db)
            dt, t_warm, n_calls, seg = dt + dtb, t_warm + twb, n_calls + ncb, seg + segb
            log(f" batch {b + 1}/{args.chain_batches}: sampling {dtb:.1f}s "
                f"(warmup {twb:.1f}s, excluded)")
        return np.concatenate(parts), np.concatenate(divs), dt, t_warm, n_calls, seg

    null_s = null_probe(x, dev, "before")
    s_host, div_a, dt, t_warm, n_calls, seg_times = batches()
    if args.segment > 0:
        if args.single_pass:
            dt = float(np.median(seg_times)) * n_calls
            log(f"single-pass steady estimate: median seg × {n_calls} = {dt:.1f}s")
        else:
            # a second full pass over every batch, timed
            s_host, div_a, dt, _, _, _ = batches()
    null_s = 0.5 * (null_s + null_probe(x, dev, "after"))
    log(f"steady sampling: {dt:.1f}s in {n_calls} calls (+ warmup {t_warm:.1f}s, excluded)")

    constrained = {k: v.numpy() for k, v in entry.nuts_params(torch.as_tensor(s_host), unflatten).items()}
    ess_total, rhat_max = 0.0, 0.0
    for nm in NAMES:
        post = torch.log(torch.as_tensor(constrained[nm]))
        ess = effective_sample_size(post).item()
        rhat = potential_scale_reduction(post).item()
        ess_total += ess
        rhat_max = max(rhat_max, rhat)
        log(f"  {nm:6s} ess={ess:8.1f}  rhat={rhat:.4f}")
    total_chains = args.chains * args.chain_batches
    overhead_s = n_calls * null_s
    device_s = max(dt - overhead_s, 1e-6)
    out = {
        "metric": f"nuts_ess_per_s_N{N}",
        "n": N,
        "chains": total_chains,
        "chains_per_batch": args.chains,
        "chain_batches": args.chain_batches,
        "samples": args.samples,
        "warmup": args.warmup,
        "steady_s": round(dt, 2),
        "warmup_s_excluded": round(t_warm, 2),
        "timing": (("sampling-only, segmented"
                    + (", single-pass median-of-segments" if args.single_pass else ""))
                   if args.segment > 0 else "sampling-only, one call (warmup in its own call)"),
        "ess_per_s": round(ess_total / dt, 1),
        "draws_per_s": round(total_chains * args.samples / dt, 1),
        "null_ms": round(null_s * 1e3, 1),
        "n_sampling_calls": n_calls,
        "sampling_overhead_s": round(overhead_s, 2),
        "overhead_share": round(overhead_s / dt, 3),
        "device_s_est": round(device_s, 2),
        "ess_per_s_device": round(ess_total / device_s, 1),
        "draws_per_s_device": round(total_chains * args.samples / device_s, 1),
        "rhat_max": round(rhat_max, 4),
        "divergence_rate": round(float(div_a.mean()), 4),
        "device": card_line(dev),
    }
    if args.save_draws:
        np.savez(args.save_draws, div=div_a, dt=dt, t_warm=t_warm, null_s=null_s,
                 n_sampling_calls=n_calls, n=N, chains=total_chains, samples=args.samples,
                 warmup=args.warmup, **{f"draws_{nm}": constrained[nm] for nm in NAMES})
        log(f"draws saved to {args.save_draws}")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

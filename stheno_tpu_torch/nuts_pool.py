"""Pool the per-batch NUTS draws that `nuts_bench --save-draws` writes
(counterpart of `scripts/nuts_pool.py`; a measurement tool).

When each chain batch runs as a process of its own (`nuts_bench
--batch-offset b`), this concatenates the saved batches along the chain
axis and reports the pooled diagnostics and throughput as one multi-batch
run would: R̂ and ESS over all chains (`inference.diagnostics` on the log
of the draws, as `nuts_bench`), the times summed over the batches.  It
reads the reference's files as well as the port's: the keys are the same.

    python -m stheno_tpu_torch.nuts_pool out_b0.npz out_b1.npz ...

Prints one JSON line on stdout; per-parameter diagnostics on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m stheno_tpu_torch.nuts_pool",
                                 description="Pool nuts_bench --save-draws batches.")
    ap.add_argument("paths", nargs="*", help="the batches' .npz files")
    paths = ap.parse_args(argv).paths
    if not paths:
        sys.exit("usage: nuts_pool batch0.npz batch1.npz ...")
    batches = [np.load(p) for p in paths]

    n = int(batches[0]["n"])
    samples = int(batches[0]["samples"])
    for p, b in zip(paths, batches):
        if int(b["n"]) != n or int(b["samples"]) != samples:
            sys.exit(f"{p}: n/samples mismatch with {paths[0]}")

    names = [k[6:] for k in batches[0].files if k.startswith("draws_")]
    pooled = {nm: np.concatenate([b[f"draws_{nm}"] for b in batches], axis=0) for nm in names}
    div = np.concatenate([b["div"] for b in batches], axis=0)
    dt = float(sum(float(b["dt"]) for b in batches))
    t_warm = float(sum(float(b["t_warm"]) for b in batches))
    n_calls = int(sum(int(b["n_sampling_calls"]) for b in batches))
    null_s = float(np.mean([float(b["null_s"]) for b in batches]))
    total_chains = int(sum(int(b["chains"]) for b in batches))

    from stheno_tpu_torch.inference import effective_sample_size, potential_scale_reduction

    ess_total, rhat_max = 0.0, 0.0
    for nm in names:
        post = torch.log(torch.as_tensor(pooled[nm]))
        ess = effective_sample_size(post).item()
        rhat = potential_scale_reduction(post).item()
        ess_total += ess
        rhat_max = max(rhat_max, rhat)
        log(f"  {nm:6s} ess={ess:8.1f}  rhat={rhat:.4f}")

    overhead_s = n_calls * null_s
    device_s = max(dt - overhead_s, 1e-6)
    out = {
        "metric": f"nuts_ess_per_s_N{n}",
        "n": n,
        "chains": total_chains,
        "batches_pooled": len(batches),
        "samples": samples,
        "warmup": int(batches[0]["warmup"]),
        "steady_s": round(dt, 2),
        "warmup_s_excluded": round(t_warm, 2),
        "timing": "sampling-only, per-batch processes pooled",
        "ess_per_s": round(ess_total / dt, 2),
        "draws_per_s": round(total_chains * samples / dt, 2),
        "null_ms": round(null_s * 1e3, 1),
        "n_sampling_calls": n_calls,
        "sampling_overhead_s": round(overhead_s, 2),
        "overhead_share": round(overhead_s / dt, 3),
        "device_s_est": round(device_s, 2),
        "ess_per_s_device": round(ess_total / device_s, 2),
        "draws_per_s_device": round(total_chains * samples / device_s, 2),
        "rhat_max": round(rhat_max, 4),
        "divergence_rate": round(float(div.mean()), 4),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

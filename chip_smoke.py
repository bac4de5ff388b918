#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`stheno_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit.  In one run it

1. builds the CUDA kernels from `stheno_tpu_torch/cuda/csrc/` (one nvcc
   per source, in parallel) and prints the card's name and power limit;
2. holds each kernel against its plain PyTorch version on the card, at the
   flagship's shapes and at ragged ones (kernel 1 also in f64, and at the
   examples' shapes: D = 4 at 16384², D = 9 at 4096 × 512 in f32 and f64,
   batched (64, 676, 676) at D = 9 and batched Matern52 (4, 100, 100) in
   f64; kernels 2 and 3 also at n = 1, 33, 255 and their limit 288, and
   kernel 3 on an input with garbage above the diagonal, which it must
   ignore, and on its own by |M·tril(L) − I|), with the tolerance stated;
3. runs the flagship value-and-gradient step (`-logpdf` of f3 = f1 + f2
   and its gradient in (v1, l1, l2, noise)) at N = 16384 in f32 through the
   blocked path, counts each kernel's launches in that step, and checks the
   step against an f64 computation on the card (the plain kernel matrix,
   `torch.linalg.cholesky` and autograd);
4. runs `predict` (posterior marginals of f1 at M = 1024 points given f3)
   and checks it against f64 the same way;
5. runs the performance probe's path at N = 16384 (`perf_probe`: kernel 4
   against its plain version, forcing scalars of three forwards against
   tr(K), 64 chained base blocks on kernel 2 against the library, the
   rec, iter and fused gradients at backward panels of 2048 against each
   other and I, and the fused one at 4096 against its own limit), counting
   its launches;
6. runs the state-space tier at N = 10^6 (`markov`): logpdf and gradient in
   f32 against f64 on the card, logpdf at N = 16384 against the dense f64
   logpdf, and finite posterior marginals;
7. runs the extended Mauna Loa path (`entry.mauna_loa_*`: a shared trend
   under two outputs observed jointly as `BlockData`, a `Periodic` warp, a
   constant offset, a constrained spec): at the example's N = 840 the
   example's 250 Adam steps and its own assertions; at N = 16384 one
   value-and-gradient step (launch counts, kernel 1 at D = 2 among them)
   against f64 on the card, 3 steps of `fit`, posterior marginals at
   3 × 1024 points against f64, and `rand` of joint prior and posterior
   samples, whitened; with its timings, peak memory and a profiled step;
8. times the step, its stages, `predict` and each kernel beside its plain
   version, its bound and its nearest single PyTorch call (kernel 2 also by
   block size, and kernels 2 and 3 back to back and alone on the device),
   and breaks one step and one `predict` down by device kernel with
   torch.profiler;
9. runs the pseudo-point path (`entry.pseudo_points_*`, BASELINE #2: VFE
   with inducing points in both latents of f3 = f1 + f2): (a) the example's
   400 Adam steps at its N = 600 in f64 with its own assertions; (b) at
   N = 131072 with 2 × 2048 inducing points, one −ELBO value-and-gradient
   step in f32 (launch counts, peak memory) against f64 on the card, and
   3 steps of `fit`; (c) the approximate posterior's marginals of f1 and f3
   at 2 × 1024 points against f64, and `rand_sparse`; (d) on 16384 of the
   points, the ELBO against the exact logpdf, and the exact logpdf by the
   default route and by the fused one (`config.logpdf_fused("on")`, whose
   backward launches kernel 3) against each other and f64; (e) SVGP at full
   width: the optimal Gaussian q against the collapsed ELBO in f32 and f64,
   and a Bernoulli minibatch step (|B| = 4096) against f64, then 3 Adam
   steps; (f) Laplace with Bernoulli labels at N = 8192 (20 Newton steps,
   each factoring an 8192² B) against f64; (g) the path's timings, a
   profiled −ELBO step and kernel 1 at 2048 × 131072;
10. runs the samplers' path (BASELINE #5 and the SMC example), every
   log-density evaluation a `torch.func.vmap` over chains or particles
   through one batched launch of kernel 1: (a) the batched kernel 1 against
   its batched plain version at (16, 2048²) f32 SE and (512, 50²) f64 SE
   and Matern32; (b) the vmapped log-density of the NUTS model at N = 2048
   over 16 jittered positions, f32 against f64 and against a loop over the
   chains, with one batched kernel-1 launch and no launch of kernels 2 and
   3; (c) the example's NUTS at its own size (N = 60, f64, 4 chains,
   300 + 400) with its assertions and R̂ ≤ 1.05; (d) NUTS at full width
   (N = 2048, f32, 16 chains, max_depth 8): warmup, then a timed sampling
   run from its state (ESS/s, draws/s, leapfrogs per transition, the
   gradient's time, peak memory, a profiled transition), R̂, divergences
   and the truth inside the posterior, and a run cut into two resumed
   halves against one run, bit for bit; (e) SMC (the example: N = 50, 512
   particles, f64) for the SE and Matern32 models with its assertions;
11. runs derivative and convolved processes, the NKN and pathwise sampling:
   kernel 1's forward-mode rule (the kernel's primal, a plain tangent) in
   f32 against `torch.func.jvp` over the plain version in f64, first and
   nested tangents, SE and Matern32, D = 1 and 2; (a) the gradient-enhanced
   GP (f and f′ observed jointly, N = 16384): one −logpdf and gradient step
   and the posterior of f, f′ and f″ at 3 × 1024 points against f64 (with
   cuSOLVER's f32 route beside them for scale), the covariance's blocks
   timed alone, a profiled step; (b) pathwise posterior samples of the
   flagship programme (S = 64, F = 1024) against f64, f1 + f2 against f3,
   and their mean against `predict`; (c) deconvolution (Cf observed at
   N = 16384 on 2048 quadrature nodes): step and posterior against f64, and
   which base cases the f32 gradient's error follows; (d) the NKN example's
   own run and one step at N = 8192 against f64; and the examples
   `differentiation.py` and `quadrature_convolution.py` with their checks;
12. runs the distributed tier (`stheno_tpu_torch.parallel`) on a one-rank
   NCCL 'rows' mesh (one card: NCCL runs one rank a GPU), each part against
   f64 on the card: (a) the flagship's −logpdf and gradient through
   `sharded_logpdf` at N = 16384 (the slab from kernel 1, the cyclic panel
   loop, the collectives) against f64 and against the single-card step,
   timed beside it and profiled, then `big_gp_logpdf` and
   `distributed_mvn_logpdf` on the same K; (b) `examples/big_n_sharded.py`'s
   full-scale run at N = 32768: `sharded_logpdf`, `sharded_posterior` of f1
   at 1024 points and `sharded_rand`, whitened; (c) the matrix-free ring:
   `ring_gp_logpdf` and its y-gradient at N = 16384 with the reference
   probe's ring_p1 settings against the dense logpdf (the limit: five
   standard deviations of the SLQ estimate over four more probe seeds) and
   −K̂⁻¹y, and `ring_posterior_mean_var` at N = 32768 and 1024 points; (d)
   `svgp_elbo_dp` at phase 9's SVGP configuration against `svgp_elbo`, f32
   and f64; (e) `run_nuts_sharded` and `run_smc_sharded` equal bit for bit
   to phase 10's runs.  Every distributed path launches kernel 1 (the
   samplers its batched launch) and counts its collectives;
13. runs the ten examples that `stheno_tpu_torch.examples` holds as
   modules (`chip_smoke.examples_path`), each at its own size with its own
   checks, counting kernel 1's launches (batched ones too: the
   convolutional GP's `var2` over its images, getting-started's NUTS over
   4 chains); then three at full width, f32 against f64 on the card, with
   launches, peak memory and times: (a) sensor fusion (BASELINE #3) at
   N = 16384, a −logpdf and gradient step in (v, l, s1, s2) and the joint
   posterior of f, y1 and y2 at 3 × 1024 points; (b) deep kernel learning
   at N = 16384, a step in the MLP's weights, v and the noise, kernel 1 at
   D = 4; (c) the convolutional GP's patch-space VFE on 4096 images of
   28 × 28 with 512 inducing points, a −ELBO and gradient step in
   (var, l) at var = P⁻² (f the patch average) taken 512 images at a
   time, profiled; and kernel 1 timed at the examples' shapes beside its
   plain version and its bound.

Every check that fails raises, so the script exits non-zero before its last
line, which is `{"ok": true, "device": {...}}`.  There is no CPU fallback:
without CUDA it exits non-zero and prints no result.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

N = 16384
M = 1024
NM = 1_000_000  # the state-space tier's N
#: the Mauna Loa path at full width: the flagship's N split as about a
#: daily record of CO₂ (1980–2020) and of temperature (1985–2020)
ML_FULL = (12288, 4096)
ML_XP = 1024  # prediction points per output
ML_POST_NOISE = 1e-3  # the f32 posterior samples' query noise (see phase 7)
ML_VAL_TOL = 1e-3  # the f32 value's limit against f64 (see phase 7)
ML_MEAN_TOL_REL = 1e-2  # the f32 posterior mean's, of max|mean64| (see phase 7)
#: the kernels of the flagship step and of `predict`
FLAGSHIP_KERNELS = ("kernelmatrix", "chol_block", "tri_inv_block")
#: the kernels of the probe's path, and the rows of it run here
PROBE_KERNELS = ("km_se_d1", "chol_block", "tri_inv_block")
PROBE_ROWS = ("null", "chol_cur", "chol_grad", "chol_grad_fused4096", "chol_btri", "chol_pal_all",
              "base_chain", "km_xla", "km_pal")
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 rate outside
# the tensor cores; one SM's fp32 rate is 1/132 of the card's.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: an H100 SXM's f64 rate outside the tensor cores (NVIDIA's data sheet)
FP64_FLOP_PER_S = 34e12
SMS = 132
# device kernels grouped by a substring of their (lower-cased) names
#: the pseudo-point path: N observations, inducing inputs per latent,
#: prediction points per process, the subset on which the exact logpdf
#: fits the card, the SVGP minibatch, the Laplace N
PP_N = 131072
PP_M = 2048
PP_XP = 1024
PP_SUB = 16384
PP_BATCH = 4096
PP_LAPLACE_N = 8192
#: kernel 1 against its plain version: absolute, values in [0, σ²] with
#: σ² ≤ 1.7 (fp32 exp/FMA rounding)
KM_TOL = 1e-5
PP_VAL_TOL = 1e-3  # the full-width f32 −ELBO's limit against f64 (relative)
#: the SVGP bound at the optimal q against the collapsed ELBO (relative):
#: f64 holds the identity to rounding; f32 to the value's own limit
PP_SVGP_TOL = {"float64": 1e-8, "float32": PP_VAL_TOL}
#: the samplers' path: the NUTS example's own size (N, chains, warmup,
#: samples, f64) and the full width (N, chains, max_depth; warmup and
#: samples cut from the bench's 300 + 500 to fit the phase's time: the
#: warmup's first 54 iterations run at a unit mass matrix, where a
#: transition takes 50-190 batched evaluations of about 44 ms each)
NUTS_SMALL = (60, 4, 300, 400)
NUTS_FULL = (2048, 16, 8)
NUTS_FULL_WARMUP, NUTS_FULL_SAMPLES = 60, 100
NUTS_SEED = 11
SMC_PARTICLES = 512
#: phase 11: the derivative path's N (f at N/2 points, f′ at N/2) and
#: prediction points per process; pathwise samples and features a leaf; the
#: deconvolution's quadrature nodes; the NKN step's N and the example's
#: Adam steps (its `--fast` run)
DERIV_N, DERIV_M = 16384, 1024
PW_S, PW_F = 64, 1024
DECONV_Q = 2048
NKN_N, NKN_STEPS = 8192, 120
#: phase 12: the distributed tier on a one-rank NCCL 'rows' mesh: the full
#: width of `examples/big_n_sharded.py`'s full-scale run (its `--n 32768`),
#: prediction points, the seeds whose SLQ estimates set the ring value's
#: limit, and the ring posterior's CG tolerance (the ring logpdf takes the
#: probe's ring_p1 settings and y-gradient limit, `perf_probe.RING_P1` and
#: `RING_YGRAD_RTOL`)
PAR_BIG_N = 32768
PAR_XP = 1024
PAR_RING_SEEDS = 4
PAR_RING_POST_TOL = 1e-5
#: kernel 1's forward-mode rule against forward mode through the plain
#: version (absolute; fp32 tangents of order 1)
JVP_TOL = 1e-5
#: phase 13: the full-width runs (a) sensor fusion, y1 and y2 at SF_N_PER
#: points each and the posterior at 3 × SF_XP, (b) deep kernel learning,
#: (c) the convolutional GP's VFE on CONV_IMAGES images of CONV_H²
#: (MNIST's shape) with CONV_M inducing points in patch space, taken
#: CONV_CHUNK images at a time; kernel 1's D = 9 row at KM_D9_ROWS patch rows
#: against the inducing points and its batched row over KM_BATCH_IMAGES
SF_N_PER = 8192
SF_XP = 1024
#: (a)'s f32 gradient against f64, of its largest component, at the
#: example's noise scales (√0.01 and √0.1; condition about 8e5).  The
#: noise scales' derivatives are differences of two terms of order N/σ²,
#: and s2's reads Σα over its sensor's block through the 3.5·s2 bias mean:
#: 5e-3 holds on no f32 route here (on an H100, 700 W, cuSOLVER's f32
#: reads 2.64e-2 as the port does; this function on the CPU at full size
#: reads LAPACK's 5.6e-3 and the port's blocked route 1.04e-2; PERF.md §6).
#: At noise scales SF_UNIT_SCALE (condition about 8e3) the step is held to
#: phase 3's 5e-3.
SF_GRAD_TOL = 5e-2
SF_UNIT_SCALE = 1.0
DKL_N = 16384
CONV_IMAGES, CONV_H, CONV_M, CONV_CHUNK = 4096, 28, 512, 512
#: (c)'s step at g's variance P⁻² (P = 676 patches an image, l = 1): f the
#: average of g over an image's patches, its prior variance at most 1.  At
#: the example's variance 1 (f the sum, prior variance about 4.6e5 an
#: image) the bound's B = I + AAᵀ/σ² has a condition of order
#: N·4.6e5/0.1 ≈ 2e10, past f32's 1/ε ≈ 1.7e7: its f32 factor breaks (NaN
#: on an H100 at 4096 images, and on the CPU at 512), f64 does not
CONV_VAR = 1.0 / (CONV_H - 2) ** 4
KM_D9_ROWS, KM_BATCH_IMAGES = 4096, 64
#: kernel 1 in f64 against its plain version (same arithmetic, values ≤ 1.7)
KM_TOL64 = 1e-12
#: the query noise of phase 11's posterior marginals, in f32 and f64 alike
PRED_NOISE = 1e-6
#: Matern pairs closer than this are left out of the nested jvp comparison:
#: ten f32 epsilons, past the masked square root's clamp (distance ≤ eps)
NEAR = 10 * 1.1920928955078125e-07
#: the gradient-enhanced path at σ² = 0.01, condition about 2.4e5 (its
#: λmax/σ²): the step's f32 gradient against f64, of its largest component
#: (the noise derivative, a difference of two terms of order N/σ²).  At
#: these inputs cuSOLVER's own f32 route reads 1.4e-2 (H100 80GB HBM3,
#: 700 W), so the limits of PERF.md §2 (5e-3) cannot hold here on any f32
#: route; `stheno_tpu_torch/accuracy_probe.py` shows the spread over data
#: seeds.  The deconvolution step keeps 5e-3, the means 1e-3
DERIV_GRAD_TOL = 2e-2
#: the same gradients at σ² = 1 (condition about 2.4e3), where f32
#: resolves every component: v, l and the noise, each against its own f64
#: value
COMPONENT_NOISE = 1.0
COMPONENT_TOL = 1e-3
PROFILE_KINDS = (
    ("kernelmatrix", ("km_kernel",)),
    ("chol_block", ("chol_block_kernel",)),
    ("tri_inv_block", ("tri_inv_kernel",)),
    ("gemm", ("gemm",)),
    ("trsm", ("trsm", "trsv")),
    ("elementwise", ("elementwise",)),
    ("concatenate", ("catarray",)),
    ("reduce", ("reduce",)),
)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps, warmup=2):
    """Mean device time of `fn()` in ms, from CUDA events around `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, kernel, reps, warmup=2):
    """Mean device duration in ms of the launches of `kernel` (a substring of
    the device kernel's name) over `reps` calls of `fn()`, from a
    torch.profiler trace: the kernel's own time, without the host's gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a trace on an H100 once came back without the kernel's device events:
    # up to three windows are traced, and the first that holds them is read
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if spans:
            return sum(spans) / len(spans) / 1e3
    require(False, f"three profiler traces held no device kernel named like {kernel!r}")


def host_ms(fn, reps, warmup=1):
    """Median host-clock time of `fn()` ending in a synchronize, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_ms(fn, top=12):
    """Device time of one `fn()` by kernel name, from a torch.profiler trace:
    the busiest kernels, the device's busy time (union of kernel intervals)
    and the host-clock wall time of the call, all in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"device_ms": "not measured (the trace holds no device events)", "wall_ms": wall_ms}
    by_name, busy_us, cur_s, cur_e = {}, 0.0, spans[0][0], spans[0][0]
    for s, e, name in spans:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (e - s), cnt + 1)
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s = s
        cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    by_kind = {}
    for name, (t, _) in by_name.items():
        low = name.lower()
        kind = next((k for k, keys in PROFILE_KINDS if any(s in low for s in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + t / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "device_kernel_ms": sum(t for t, _ in by_name.values()) / 1e3,
            "kernels": len(spans),
            "top": [{"name": name[:90], "ms": t / 1e3, "count": c} for name, (t, c) in ranked[:top]]}


def bound(nbytes, flops, flop_rate=FP32_FLOP_PER_S):
    """Least card-wide time (ms) and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def numerics_policy(torch):
    """The port's GEMMs run in full fp32: TF32 stays off."""
    require(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on")
    require(torch.get_float32_matmul_precision() == "highest",
            "float32 matmul precision is not 'highest'")


def spd_blocks(torch, batch, n, dtype, device, seed):
    """A batch of well-scaled SPD blocks made from a seed."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    G = torch.randn(batch, n, n, generator=g, dtype=torch.float64).to(device)
    A = G @ G.mT / n + torch.eye(n, dtype=torch.float64, device=device)
    return A.to(dtype=dtype)

def cond_estimate(torch, fx, noise, iters=30):
    """λmax(K + σ²I)/σ² for the FiniteGP `fx` (f64), λmax by power
    iteration: an upper estimate of the covariance's condition (λmin ≥ σ²)."""
    with torch.no_grad():
        K = fx.cov()
        v = torch.ones(K.shape[0], dtype=K.dtype, device=K.device)
        lam = 0.0
        for _ in range(iters):
            w = K @ v
            lam = w.norm().item() / v.norm().item()
            v = w / w.norm()
        del K
    return lam / noise


def counts_now(kern):
    """Each kernel's launches since the last reset, total and by shape."""
    return ({k: c.total for k, c in kern.COUNTERS.items()},
            {k: {str(sh): v for sh, v in c.by_shape.items()} for k, c in kern.COUNTERS.items()})


def pseudo_point_path(torch, dev, card, flagship_step, flagship_theta):
    """Phase 9: the pseudo-point path (BASELINE #2).  Returns the launch
    counts of its −ELBO step and kernel 1's row at 2048 × 131072."""
    import numpy as np

    import stheno_tpu_torch as stt
    from stheno_tpu_torch import cuda as kern
    from stheno_tpu_torch import entry as E
    from stheno_tpu_torch import params as P
    from stheno_tpu_torch.cuda.kernelmatrix import kernelmatrix_forward, kernelmatrix_plain
    from stheno_tpu_torch.finite_gp import VFE, _vfe_factors, rand_sparse
    from stheno_tpu_torch.inference import (
        SVGP, BernoulliLikelihood, laplace, svgp_elbo, svgp_init, svgp_optimal_gaussian)

    f32, f64 = torch.float32, torch.float64

    # (a) the example's own size, N = 600 and 24 inducing inputs per latent
    # on [−8, 8], f64 (the example sets x64): the small torch.linalg route,
    # kernel 1 in f64.  Its 400 Adam steps at 2e-2 and its assertions
    # (`entry.pseudo_points_example`)
    kern.reset_counters()
    pp_small = E.pseudo_points_example(400, 2e-2, f64, dev)
    torch.cuda.synchronize()
    small_counts, _ = counts_now(kern)
    emit({"pseudo_points_small": {**pp_small, "dtype": "float64", "learning_rate": 2e-2,
                                  "fit_ms_per_step": pp_small["fit_s"] * 1e3 / 400,
                                  "launches": small_counts, "card": card}})
    require(small_counts["kernelmatrix"] > 0, "kernel 1 was not launched by the N = 600 fit")

    # (b) full width: N = 131072, 2 × 2048 inducing points, f32
    data = E.pseudo_points_data(PP_N, PP_M, f32, dev)
    data64 = tuple(t.to(f64) for t in data)  # the same f32-rounded inputs
    theta0, _ = P.init(E.pseudo_points_spec(data[2]))
    # θ's constrained values in θ's own dtype (a spec's unflatten casts to
    # the dtype it was made in)
    unflattens = {dt: P.init(E.pseudo_points_spec(data[2].to(dt)))[1] for dt in (f32, f64)}

    def unflatten(theta):
        return unflattens[theta.dtype](theta)

    torch.cuda.synchronize()
    kern.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    val, grad = E.pseudo_points_step(theta0, data)
    torch.cuda.synchronize()
    peak_step_gib = torch.cuda.max_memory_allocated() / 2**30
    step_counts, step_shapes = counts_now(kern)
    emit({"pseudo_point_step_launches": step_counts, "pseudo_point_step_launches_by_shape": step_shapes})
    for name in FLAGSHIP_KERNELS:
        require(step_counts[name] > 0, f"kernel {name} was not launched by the pseudo-point step")
    require(math.isfinite(val.item()) and bool(torch.isfinite(grad).all()),
            "pseudo-point step is not finite")
    torch.cuda.empty_cache()
    val64, grad64 = E.pseudo_points_step(theta0.to(f64), data64)
    val_rel = abs(val.item() - val64.item()) / abs(val64.item())
    grad_rel = ((grad.to(f64) - grad64).abs().max() / grad64.abs().max()).item()

    def trace_sums(theta, d):
        """Σ kff/s and Σ A² of the trace term, which cancel to far less than
        either: f32's error in the value is read off them."""
        with torch.no_grad():
            fx, u = E.pseudo_points_observations(unflatten(theta.to(d[0].dtype)), d[0])
            _, A, _, sqrt_s = _vfe_factors(VFE(u), fx)
            return (fx.f.var(fx.x) / sqrt_s**2).sum().item(), (A * A).sum().item()

    sums32, sums64 = trace_sums(theta0, data), trace_sums(theta0.to(f64), data64)
    torch.cuda.empty_cache()
    emit({"pseudo_point_check": {
        "n": PP_N, "inducing": 2 * PP_M, "neg_elbo_f32": val.item(), "neg_elbo_f64": val64.item(),
        "neg_elbo_rel_err": val_rel, "tolerance": PP_VAL_TOL,
        "grad_hyper_f32": grad[:5].tolist(), "grad_hyper_f64": grad64[:5].tolist(),
        "grad_order": "l1, l2, noise, v1, v2, then z",
        "grad_max_err_rel_to_largest": grad_rel, "grad_tolerance": 5e-3,
        "trace_sum_kff_over_s": {"f32": sums32[0], "f64": sums64[0]},
        "trace_sum_A2": {"f32": sums32[1], "f64": sums64[1]},
        "trace_difference": {"f32": sums32[0] - sums32[1], "f64": sums64[0] - sums64[1]},
        "peak_step_gib": peak_step_gib}})
    require(val_rel <= PP_VAL_TOL, f"pseudo-point −ELBO rel err {val_rel} > {PP_VAL_TOL}")
    require(grad_rel <= 5e-3, f"pseudo-point gradient err {grad_rel} > 5e-3 of the largest")
    del grad64

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit3 = E.pseudo_points_fit(3, 2e-2, data=data)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3 / 3
    losses = fit3.losses.tolist()
    emit({"pseudo_point_fit3_losses": losses})
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            f"pseudo-point fit at N = {PP_N}: losses {losses}")

    # (c) the approximate posterior: marginals of f1 and f3 at 2 × 1024
    # points against f64; `rand_sparse` of a SparseFiniteGP on the subset
    params = fit3.params
    params64 = {k: v.to(f64) for k, v in params.items()}
    xp = torch.linspace(-1000.0, 1000.0, PP_XP, dtype=f32, device=dev)
    kern.reset_counters()
    ms = E.pseudo_points_predict(params, data, xp)
    torch.cuda.synchronize()
    predict_counts, _ = counts_now(kern)
    for name in FLAGSHIP_KERNELS:
        require(predict_counts[name] > 0, f"kernel {name} was not launched by pseudo_points_predict")
    ms64 = E.pseudo_points_predict(params64, data64, xp.to(f64))
    mean_err = (ms.mean.to(f64) - ms64.mean).abs().max().item()
    var_err = (ms.var.to(f64) - ms64.var).abs().max().item()
    mean_tol = 1e-2 * ms64.mean.abs().max().item()
    var_tol = 1e-3 * ms64.var.abs().max().item()
    rng = np.random.default_rng(1)
    sub = torch.as_tensor(np.sort(rng.choice(PP_N, PP_SUB, replace=False)), device=dev)
    x_sub, y_sub = data[0][sub], data[1][sub]
    with torch.no_grad():
        fx_sub, u0 = E.pseudo_points_observations(params, x_sub)
        ys = rand_sparse(torch.Generator(device=dev).manual_seed(0), stt.SparseFiniteGP(fx_sub, u0), 4)
    emit({"pseudo_point_predict_check": {
        "points": 2 * PP_XP, "mean_max_abs_err": mean_err, "mean_tolerance": mean_tol,
        "var_max_abs_err": var_err, "var_tolerance": var_tol,
        "mean_range": [ms64.mean.min().item(), ms64.mean.max().item()],
        "var_range": [ms64.var.min().item(), ms64.var.max().item()], "launches": predict_counts,
        "rand_sparse": {"shape": list(ys.shape), "finite": bool(torch.isfinite(ys).all())}}})
    require(bool(torch.isfinite(ms.mean).all() and torch.isfinite(ms.var).all()),
            "pseudo-point predict not finite")
    require(mean_err <= mean_tol, f"pseudo-point predict mean err {mean_err} > {mean_tol}")
    require(var_err <= var_tol, f"pseudo-point predict var err {var_err} > {var_tol}")
    require(bool(torch.isfinite(ys).all()) and ys.shape == (PP_SUB, 4), "rand_sparse samples")
    del ms64, ys, fx_sub, u0
    torch.cuda.empty_cache()

    # (d) on 16384 of the points, where the exact logpdf fits the card: the
    # bound, and the exact −logpdf and its gradient in the hyperparameters
    # (θ's first five entries) by the default route and the fused one
    sub_data = (x_sub, y_sub, data[2])
    sub64 = tuple(t.to(f64) for t in sub_data)

    def exact(theta, d, count_backward=False):
        th = theta.detach().requires_grad_(True)
        fx, _ = E.pseudo_points_observations(unflatten(th), d[0])
        v = -stt.logpdf(fx, d[1])
        if count_backward:
            kern.reset_counters()
        (g,) = torch.autograd.grad(v, th)
        torch.cuda.synchronize()
        return v.item(), g[:5], counts_now(kern)[0]

    with torch.no_grad():
        elbo_lp = {dt: (-E.pseudo_points_neg_elbo(unflatten(theta0.to(dt)), d).item(),
                      stt.logpdf(E.pseudo_points_observations(unflatten(theta0.to(dt)), d[0])[0],
                                 d[1]).item())
                   for dt, d in ((f32, sub_data), (f64, sub64))}
    v_def, g_def, _ = exact(theta0, sub_data)
    with stt.config.logpdf_fused("on"):
        v_fused, g_fused, fused_bwd_counts = exact(theta0, sub_data, count_backward=True)
    v64, g64, _ = exact(theta0.to(f64), sub64)

    def rel(a, b):
        return abs(a - b) / abs(b)

    def grad_err(a, b):
        return ((a.to(f64) - b).abs().max() / b.abs().max()).item()

    fused_check = {
        "n": PP_SUB, "elbo_f32": elbo_lp[f32][0], "logpdf_f32": elbo_lp[f32][1],
        "elbo_f64": elbo_lp[f64][0], "logpdf_f64": elbo_lp[f64][1],
        "neg_logpdf": {"default": v_def, "fused": v_fused, "f64": v64},
        "value_rel_err": {"default": rel(v_def, v64), "fused": rel(v_fused, v64),
                          "fused_vs_default": rel(v_fused, v_def)},
        "grad_err_rel_to_largest": {"default": grad_err(g_def, g64), "fused": grad_err(g_fused, g64),
                                    "fused_vs_default": grad_err(g_fused, g_def.to(f64))},
        "value_tolerance": 1e-4, "grad_tolerance": 5e-3, "fused_backward_launches": fused_bwd_counts}
    emit({"pseudo_point_bound_check": fused_check})
    for dt, (e, lp) in elbo_lp.items():
        require(e <= lp, f"ELBO {e} > logpdf {lp} ({dt})")
    require(fused_bwd_counts["tri_inv_block"] > 0, "kernel 3 was not launched by the fused backward")
    for key, e in fused_check["value_rel_err"].items():
        require(e <= 1e-4, f"exact logpdf at {PP_SUB} ({key}): value rel err {e} > 1e-4")
    for key, e in fused_check["grad_err_rel_to_largest"].items():
        require(e <= 5e-3, f"exact logpdf at {PP_SUB} ({key}): gradient err {e} > 5e-3")
    del sub64
    torch.cuda.empty_cache()

    # (e) SVGP at full width: the optimal Gaussian q gives the collapsed
    # ELBO (f32 and f64); a Bernoulli minibatch step against f64; 3 Adam steps
    svgp_check = {}
    for dt, d in ((f32, data), (f64, data64)):
        with torch.no_grad():
            fx, u = E.pseudo_points_observations(unflatten(theta0.to(dt)), d[0])
            q = svgp_optimal_gaussian(svgp_init(u), fx, d[1])
            e_svgp, e_vfe = svgp_elbo(q, fx, d[1]).item(), stt.elbo(VFE(u), fx, d[1]).item()
        svgp_check[str(dt).split(".")[-1]] = {"svgp_elbo_at_optimum": e_svgp, "collapsed_elbo": e_vfe,
                                              "rel_diff": rel(e_svgp, e_vfe)}
        if dt == f32:
            q_mu0, q_sqrt0 = q.q_mu, q.q_sqrt
        del fx, u, q
        torch.cuda.empty_cache()
    labels = (data[1] > 0).to(f32)
    scale = PP_N / PP_BATCH
    lik = BernoulliLikelihood()

    def svgp_neg(th, q_mu, q_sqrt, idx, dt=f32):
        t = unflatten(th)
        f = E.build_pseudo_points(t)
        u = f(stt.BlockData(stt.GPPPInput("f1", t["z"]), stt.GPPPInput("f2", t["z"])),
              E.PP_INDUCING_NOISE)
        fx = f(stt.GPPPInput("f3", data[0][idx].to(dt)), E.PP_INDUCING_NOISE)
        return -svgp_elbo(SVGP(u, q_mu, q_sqrt), fx, labels[idx].to(dt), scale=scale, likelihood=lik)

    def svgp_step(dt, idx):
        leaves = [a.detach().to(dt).requires_grad_(True) for a in (theta0, q_mu0, q_sqrt0)]
        v = svgp_neg(*leaves, idx, dt)
        return v.item(), torch.autograd.grad(v, leaves)

    rng = np.random.default_rng(2)
    batch = torch.as_tensor(np.sort(rng.choice(PP_N, PP_BATCH, replace=False)), device=dev)
    kern.reset_counters()
    sv32, sg32 = svgp_step(f32, batch)
    torch.cuda.synchronize()
    svgp_counts, svgp_shapes = counts_now(kern)
    sv64, sg64 = svgp_step(f64, batch)
    svgp_grad_err = {name: grad_err(a, b) for name, a, b in zip(("theta", "q_mu", "q_sqrt"), sg32, sg64)}
    opt_leaves = [a.detach().clone().requires_grad_(True) for a in (theta0, q_mu0, q_sqrt0)]
    opt = torch.optim.Adam(opt_leaves, lr=1e-2)
    svgp_losses = []
    for _ in range(3):
        idx = torch.as_tensor(np.sort(rng.choice(PP_N, PP_BATCH, replace=False)), device=dev)
        opt.zero_grad(set_to_none=True)
        loss = svgp_neg(*opt_leaves, idx)
        loss.backward()
        opt.step()
        svgp_losses.append(loss.item())
    emit({"pseudo_point_svgp_check": {
        "optimum_vs_collapsed": svgp_check, "tolerance_rel": PP_SVGP_TOL,
        "minibatch": PP_BATCH, "scale": scale, "neg_elbo_f32": sv32, "neg_elbo_f64": sv64,
        "value_rel_err": rel(sv32, sv64), "grad_err_rel_to_largest": svgp_grad_err,
        "value_tolerance": PP_VAL_TOL, "grad_tolerance": 5e-3, "adam_losses": svgp_losses,
        "launches": svgp_counts, "launches_by_shape": svgp_shapes}})
    for key, c in svgp_check.items():
        require(c["rel_diff"] <= PP_SVGP_TOL[key],
                f"SVGP at the optimum against the collapsed ELBO ({key}): {c['rel_diff']}")
    for name in FLAGSHIP_KERNELS:
        require(svgp_counts[name] > 0, f"kernel {name} was not launched by the SVGP step")
    require(rel(sv32, sv64) <= PP_VAL_TOL, f"SVGP minibatch value rel err {rel(sv32, sv64)}")
    for name, e in svgp_grad_err.items():
        require(e <= 5e-3, f"SVGP minibatch gradient ({name}) err {e} > 5e-3 of the largest")
    require(all(math.isfinite(v) for v in svgp_losses), f"SVGP Adam losses {svgp_losses}")
    del sg32, sg64, opt, opt_leaves
    torch.cuda.empty_cache()

    # (f) Laplace at N = 8192, the example's part 1 at its density (15 a
    # unit) on [−273, 273]: labels Bernoulli(Φ(2 sin x)), SE (1.0, 0.5), 20
    # Newton steps, each factoring an 8192² B
    rng = np.random.default_rng(3)
    xl = np.sort(rng.uniform(-273.0, 273.0, PP_LAPLACE_N))
    p1 = torch.special.ndtr(torch.as_tensor(2.0 * np.sin(xl))).numpy()
    yl = (rng.uniform(size=PP_LAPLACE_N) < p1).astype(np.float64)

    def laplace_value_and_grad(dt):
        v = torch.tensor(1.0, dtype=dt, device=dev, requires_grad=True)
        ell = torch.tensor(0.5, dtype=dt, device=dev, requires_grad=True)
        with stt.GPC():
            g = stt.GP(v * stt.with_lengthscale(stt.SEKernel(), ell))
        x = torch.as_tensor(xl, dtype=dt, device=dev)
        res = laplace(g(x, 1e-9), torch.as_tensor(yl, dtype=dt, device=dev), lik, num_iters=20)
        grads = torch.autograd.grad(res.log_evidence, (v, ell))
        return res.log_evidence.item(), [a.item() for a in grads], res.newton_decrement.item()

    kern.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    lz32, lg32, dec32 = laplace_value_and_grad(f32)
    torch.cuda.synchronize()
    laplace_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    laplace_counts, _ = counts_now(kern)
    torch.cuda.empty_cache()
    lz64, lg64, dec64 = laplace_value_and_grad(f64)
    torch.cuda.empty_cache()
    lap_grad_rel = [abs(a - b) / abs(b) for a, b in zip(lg32, lg64)]
    emit({"laplace_check": {"n": PP_LAPLACE_N, "newton_steps": 20, "log_evidence_f32": lz32,
                            "log_evidence_f64": lz64, "value_rel_err": rel(lz32, lz64),
                            "grad_f32": lg32, "grad_f64": lg64, "grad_rel_err": lap_grad_rel,
                            "value_tolerance": 1e-4, "grad_tolerance": 5e-3,
                            "newton_decrement_f32": dec32, "newton_decrement_f64": dec64,
                            "decrement_tolerance_f64": 1e-8, "peak_gib_f32": laplace_peak_gib,
                            "launches": laplace_counts}})
    for name in FLAGSHIP_KERNELS:
        require(laplace_counts[name] > 0, f"kernel {name} was not launched by laplace")
    require(rel(lz32, lz64) <= 1e-4, f"laplace log evidence rel err {rel(lz32, lz64)} > 1e-4")
    require(max(lap_grad_rel) <= 5e-3, f"laplace gradient rel err {lap_grad_rel} > 5e-3")
    require(dec64 < 1e-8, f"laplace f64 newton decrement {dec64} >= 1e-8")

    # (g) timings (host clock around synchronize, median of 3 after a
    # warm-up), a profiled −ELBO step, and kernel 1 at 2048 × 131072
    batch_idx = batch
    timings = {
        "vfe_step_ms": host_ms(lambda: E.pseudo_points_step(theta0, data), reps=3),
        "vfe_fit_ms_per_step": fit_ms, "vfe_fit_small_ms_per_step": pp_small["fit_s"] * 1e3 / 400,
        "vfe_predict_ms": host_ms(lambda: E.pseudo_points_predict(params, data, xp), reps=3),
        "svgp_step_ms": host_ms(lambda: svgp_step(f32, batch_idx), reps=3),
        "laplace_ms": host_ms(lambda: laplace_value_and_grad(f32), reps=3),
        "exact_step_16384_ms": host_ms(lambda: exact(theta0, sub_data), reps=3),
    }
    with stt.config.logpdf_fused("on"):
        timings["exact_step_16384_fused_ms"] = host_ms(lambda: exact(theta0, sub_data), reps=3)
    # the flagship step, default and fused, back to back in this phase
    timings["step_ms"] = host_ms(lambda: flagship_step(flagship_theta), reps=3)
    with stt.config.logpdf_fused("on"):
        timings["fused_step_ms"] = host_ms(lambda: flagship_step(flagship_theta), reps=3)
    timings["step_ms_after"] = host_ms(lambda: flagship_step(flagship_theta), reps=3)
    # the −ELBO step's flops, 10·M²N in all: the forward's solve of N
    # right-hand sides against the M² Luu (M²N) and the Gram AAᵀ (2M²N); the
    # backward's two GEMMs of the Gram's adjoint (4M²N), the solve's adjoint
    # (M²N) and its outer product L̄ = −tril(b̄ xᵀ) (2M²N)
    m_tot = 2 * PP_M
    step_flops = 10 * m_tot**2 * PP_N
    step_bound, step_by = bound(0, step_flops)
    emit({"pseudo_points": {"n": PP_N, "inducing": m_tot, "dtype": "float32", **timings,
                            "step_bound_ms": step_bound, "step_bound_by": step_by,
                            "step_flops": step_flops, "peak_step_gib": peak_step_gib,
                            "launches_by_kernel": step_counts, "card": card}})
    emit({"profile_pseudo_point_step": profile_ms(lambda: E.pseudo_points_step(theta0, data))})

    zs = (data[2] / 1.0)[:, None].contiguous()
    xs = (data[0] / 1.0)[:, None].contiguous()
    v08 = torch.tensor(0.8, dtype=f32, device=dev)
    with torch.no_grad():
        cross_err = (kernelmatrix_forward(zs, xs, "se", v08)
                     - kernelmatrix_plain(zs, xs, "se", v08)).abs().max().item()
    require(cross_err <= KM_TOL,
            f"kernelmatrix cross {PP_M}x{PP_N}: max abs err {cross_err} > {KM_TOL}")
    cross = {"shape": f"cross {PP_M}x{PP_N} D=1 SE f32", "max_abs_err": cross_err,
             "ms": event_ms(lambda: kernelmatrix_forward(zs, xs, "se", v08), reps=20),
             "plain_ms": event_ms(lambda: kernelmatrix_plain(zs, xs, "se", v08), reps=3),
             "bound_ms": bound((PP_M + PP_N + PP_M * PP_N) * 4, PP_M * PP_N * 10)[0]}
    emit({"kernelmatrix_pseudo_point_cross": cross, "card": card})
    del data, data64, sub_data, params, params64, x_sub, y_sub
    torch.cuda.empty_cache()
    return step_counts, cross


def samplers_path(torch, dev, card):
    """Phase 10: the samplers' path (BASELINE #5 and the SMC example).
    Returns the launch counts of the full-width sampling run, those of the
    SMC run, and the batched kernel 1's row."""
    import numpy as np

    from stheno_tpu_torch import cuda as kern
    from stheno_tpu_torch import entry as E
    from stheno_tpu_torch.cuda.kernelmatrix import kernelmatrix_batched_forward, kernelmatrix_plain
    from stheno_tpu_torch.inference import (
        effective_sample_size, nuts_warmup, potential_scale_reduction, run_nuts, warmup_result)
    from stheno_tpu_torch.inference.hmc import generator, nuts_kernel

    f32, f64 = torch.float32, torch.float64
    n_full, chains, max_depth = NUTS_FULL
    gen = torch.Generator(device="cpu").manual_seed(10)

    # (a) the batched kernel 1 at the path's shapes: 16 chains' lengthscales
    # on the full-width x, and 512 particles' on the SMC example's x
    data = E.nuts_data(n_full, f32, dev)
    ell = torch.exp(0.3 * torch.randn(chains, generator=gen, dtype=f64)).to(dev)
    xb = (data[0][None, :, None].double() / ell[:, None, None]).to(f32).contiguous()
    vb = torch.exp(0.3 * torch.randn(chains, generator=gen, dtype=f64)).to(dev, f32)
    smc_x = E.smc_data(50, f64, dev)[0]
    ell_p = torch.exp(torch.randn(SMC_PARTICLES, generator=gen, dtype=f64)).to(dev)
    xp = (smc_x[None, :, None] / ell_p[:, None, None]).contiguous()
    vp = torch.exp(torch.randn(SMC_PARTICLES, generator=gen, dtype=f64)).to(dev)
    checks, rows = [], {}
    for label, kind, x, v in (("nuts", "se", xb, vb), ("smc", "se", xp, vp),
                              ("smc", "matern32", xp, vp)):
        K = kernelmatrix_batched_forward(x, None, kind, v)
        Kp = kernelmatrix_plain(x, None, kind, v)
        err = (K - Kp).abs().max().item()
        diag_ok = bool((K.diagonal(dim1=-2, dim2=-1) == v[:, None]).all())
        c, n, d = x.shape
        size = x.element_size()
        b_ms, b_by = bound((c * n * d + c + c * n * n) * size, c * n * n * 12)
        row = {"kind": kind, "shape": f"batched same-input ({c}, {n}, {n}) D={d} {str(x.dtype)[6:]}",
               "max_abs_err": err, "diag_exact": diag_ok, "bound_ms": b_ms, "bound_by": b_by,
               "ms": event_ms(lambda: kernelmatrix_batched_forward(x, None, kind, v), reps=20),
               "plain_ms": event_ms(lambda: kernelmatrix_plain(x, None, kind, v), reps=3)}
        checks.append(row)
        rows.setdefault(label, row)
        require(err <= KM_TOL and diag_ok,
                f"batched kernelmatrix {row['shape']} {kind}: max abs err {err} > {KM_TOL} "
                "or diagonal not exact")
        del K, Kp
    emit({"check": "kernelmatrix_batched", "tolerance_abs": KM_TOL, "cases": checks, "card": card})

    # (b) the vmapped log-density at full width: f32 against f64 and
    # against a loop over the chains; one batched kernel-1 launch a forward
    fn, theta0, unflatten = E.nuts_logdensity(data)
    data64 = tuple(t.double() for t in data)
    fn64, _, _ = E.nuts_logdensity(data64)
    thetas = theta0[None, :] + 0.3 * torch.randn(chains, 3, generator=gen).to(dev)
    vg = torch.func.vmap(torch.func.grad_and_value(fn))
    kern.reset_counters()
    grad, val = vg(thetas)
    torch.cuda.synchronize()
    eval_counts, eval_shapes = counts_now(kern)
    emit({"samplers_eval_launches": eval_counts, "samplers_eval_launches_by_shape": eval_shapes})
    require(eval_counts["kernelmatrix_batched"] == 1 and eval_counts["kernelmatrix"] == 0,
            f"the vmapped log-density did not launch kernel 1 once, batched: {eval_counts}")
    require(eval_counts["chol_block"] == 0 and eval_counts["tri_inv_block"] == 0,
            f"the vmapped log-density launched kernel 2 or 3: {eval_counts}")
    grad64, val64 = torch.func.vmap(torch.func.grad_and_value(fn64))(thetas.double())
    val_rel = ((val.double() - val64).abs() / val64.abs()).max().item()
    grad_rel = ((grad.double() - grad64).abs().amax(dim=1) / grad64.abs().amax(dim=1)).max().item()
    loop_val, loop_grad = [], []
    for c in range(chains):
        th = thetas[c].clone().requires_grad_(True)
        v = fn(th)
        loop_val.append(v.detach())
        loop_grad.append(torch.autograd.grad(v, th)[0])
    loop_val, loop_grad = torch.stack(loop_val), torch.stack(loop_grad)
    loop_val_rel = ((val - loop_val).abs() / loop_val.abs()).max().item()
    loop_grad_rel = ((grad - loop_grad).abs().amax(dim=1) / loop_grad.abs().amax(dim=1)).max().item()
    emit({"samplers_logdensity": {"n": n_full, "chains": chains, "value_rel_err_f64": val_rel,
                                  "grad_rel_err_f64": grad_rel, "value_rel_err_loop": loop_val_rel,
                                  "grad_rel_err_loop": loop_grad_rel}})
    require(val_rel <= 1e-4, f"vmapped log-density f32 vs f64: value rel err {val_rel} > 1e-4")
    require(grad_rel <= 5e-3, f"vmapped log-density f32 vs f64: gradient err {grad_rel} > 5e-3")
    # the batched factor and the loop's single ones differ in f32 rounding
    require(loop_val_rel <= 1e-5, f"vmapped vs loop: value rel err {loop_val_rel} > 1e-5")
    require(loop_grad_rel <= 1e-3, f"vmapped vs loop: gradient err {loop_grad_rel} > 1e-3")
    grad_ms = host_ms(lambda: vg(thetas), reps=5)
    del grad64, val64, loop_val, loop_grad

    # (c) the example at its own size, with its assertions (`entry.nuts_example`)
    n_s, chains_s, warm_s, samp_s = NUTS_SMALL
    ex_out = E.nuts_example(warm_s, samp_s, chains_s, n_s, NUTS_SEED, dev)
    ex = ex_out.pop("run")
    emit({"nuts_example": {**ex_out, "dtype": "float64"}})

    # (d) full width: warmup, then a timed sampling-only run from its state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = nuts_warmup(NUTS_SEED, fn, theta0, num_warmup=NUTS_FULL_WARMUP, num_chains=chains,
                       max_depth=max_depth)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    state = warmup_result(warm)
    kern.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    theta_s, info, final = run_nuts(NUTS_SEED, fn, theta0, num_samples=NUTS_FULL_SAMPLES,
                                    num_chains=chains, max_depth=max_depth, resume_state=state,
                                    return_state=True)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    run_counts, run_shapes = counts_now(kern)
    evals = int(info.num_evals[0].sum().item())
    require(run_counts["kernelmatrix_batched"] == evals and run_counts["kernelmatrix"] == 0,
            f"the sampling run's {evals} evaluations did not each launch kernel 1 once, batched: "
            f"{run_counts}")
    require(run_counts["chol_block"] == 0 and run_counts["tri_inv_block"] == 0,
            f"the sampling run launched kernel 2 or 3: {run_counts}")
    ess = [effective_sample_size(theta_s[..., i]).item() for i in range(3)]
    rhat = potential_scale_reduction(theta_s).max().item()
    div = info.diverging.double().mean().item()
    post = {k: v.cpu().numpy().ravel() for k, v in E.nuts_params(theta_s, unflatten).items()}

    # one profiled transition from the run's final state
    step = nuts_kernel(fn, max_depth)
    with torch.no_grad():
        prof = profile_ms(lambda: step(generator(NUTS_SEED, 9, 0, dev), final.q, final.logp,
                                       final.grad, final.eps, final.inv_mass))
    full = {"n": n_full, "chains": chains, "max_depth": max_depth, "dtype": "float32",
            "warmup": NUTS_FULL_WARMUP, "samples": NUTS_FULL_SAMPLES, "warmup_s": warmup_s,
            "sampling_s": sample_s, "ess": ess, "nuts_ess_per_s": sum(ess) / sample_s,
            "draws_per_s": chains * NUTS_FULL_SAMPLES / sample_s,
            "evals_per_transition": evals / NUTS_FULL_SAMPLES,
            "leaves_per_transition": info.num_leaves.double().mean().item(),
            "tree_depth": info.tree_depth.double().mean().item(),
            "nuts_grad_ms": grad_ms, "ms_per_eval": sample_s * 1e3 / evals,
            "peak_gib": peak_gib, "divergence_rate": div, "rhat_max": rhat,
            "accept_prob": info.accept_prob.mean().item(),
            "step_size": info.step_size[:, 0].cpu().tolist(),
            "q01_q99": {k: np.quantile(v, [0.01, 0.99]).tolist() for k, v in post.items()},
            "launches": run_counts, "card": card}
    emit({"nuts_full": full})
    emit({"profile_nuts_transition": prof})
    require(rhat <= 1.05, f"NUTS full width: max split-R-hat {rhat} > 1.05")
    require(div < 0.05, f"NUTS full width: divergence rate {div} >= 0.05")
    for k in ("v", "l", "noise"):
        lo, hi = np.quantile(post[k], [0.01, 0.99])
        require(lo < E.NUTS_TRUTH[k] < hi, f"NUTS full width: true {k} outside the pooled 1-99% quantiles")

    # resume: one run of 6 draws against two resumed halves of 3, bit for bit
    whole, _ = run_nuts(NUTS_SEED, fn, theta0, num_samples=6, num_chains=chains,
                        max_depth=max_depth, resume_state=state, check_rhat=False)
    first, _, mid = run_nuts(NUTS_SEED, fn, theta0, num_samples=3, num_chains=chains,
                             max_depth=max_depth, resume_state=state, return_state=True,
                             check_rhat=False)
    second, _ = run_nuts(NUTS_SEED, fn, theta0, num_samples=3, num_chains=chains,
                         max_depth=max_depth, resume_state=mid, sample_offset=3, check_rhat=False)
    require(torch.equal(whole, torch.cat([first, second], dim=1)),
            "NUTS full width: the resumed halves differ from the uninterrupted run")
    emit({"nuts_resume_bit_identical": True, "draws": 6, "chains": chains})
    del data, data64, theta_s, info

    # (e) SMC: the example's two models, its assertions (`entry.smc_example`)
    kern.reset_counters()
    smc = E.smc_example(SMC_PARTICLES, dev)
    torch.cuda.synchronize()
    smc_se = smc.pop("results")["SE"]
    smc_counts, _ = counts_now(kern)
    emit({"smc": smc, "launches_both_models": smc_counts})
    require(smc_counts["kernelmatrix_batched"] > 0 and smc_counts["kernelmatrix"] == 0,
            f"SMC did not go through the batched kernel 1: {smc_counts}")

    row = {"name": "kernelmatrix_batched", "route": "cuda",
           "source": "stheno_tpu_torch/cuda/csrc/kernelmatrix.cu",
           "replaces": "stheno_tpu/experimental/pallas/kernelmatrix.py:101",
           "launches": run_counts["kernelmatrix_batched"],
           "max_abs_err": max(c["max_abs_err"] for c in checks),
           "ms": rows["nuts"]["ms"], "plain_ms": rows["nuts"]["plain_ms"],
           "bound_ms": rows["nuts"]["bound_ms"], "bound_by": rows["nuts"]["bound_by"],
           "library_ms": None, "shape": rows["nuts"]["shape"],
           "path": "NUTS at full width (kernel 1 with a grid dimension over the vmapped chains)",
           "launches_per_eval": run_counts["kernelmatrix_batched"] / evals,
           "launches_smc": smc_counts["kernelmatrix_batched"], "smc_shape": rows["smc"]}
    torch.cuda.empty_cache()
    return run_counts, smc_counts, row, {"nuts": ex.theta, "smc_se": smc_se}


def derivatives_path(torch, dev, card):
    """Phase 11: derivative and convolved processes, the NKN and pathwise
    sampling.  Returns the launch counts of paths (a)-(d), by path."""
    import numpy as np

    import stheno_tpu_torch as stt
    from stheno_tpu_torch import cuda as kern
    from stheno_tpu_torch import entry as E
    from stheno_tpu_torch import params as P
    from stheno_tpu_torch.cuda.kernelmatrix import kernelmatrix, kernelmatrix_plain
    from stheno_tpu_torch.ops.chol import cholesky_psd

    f32, f64 = torch.float32, torch.float64
    counts, out = {}, {"card": card}

    def jo(fn, x):
        return torch.func.jvp(fn, (x,), (torch.ones_like(x),))[1]

    def d64(t):
        return t.double() if torch.is_tensor(t) else {k: v.double() for k, v in t.items()}

    def rel(a, b):
        return ((a.double() - b).abs().max() / b.abs().max()).item()

    def grad_rel(g, g64):
        a = torch.stack([g[k].double() for k in g64])
        b = torch.stack([g64[k] for k in g64])
        return ((a - b).abs().max() / b.abs().max()).item()

    def own_rel(g, g64):
        return {k: abs(g[k].item() - g64[k].item()) / abs(g64[k].item()) for k in g64}

    def components_at_low_condition(step, theta, data):
        """The step's gradient at σ² = COMPONENT_NOISE, f32 against f64,
        each component against its own value."""
        th = dict(theta, noise=torch.tensor(COMPONENT_NOISE, dtype=f32, device=dev))
        return own_rel(step(th, data)[1], step(d64(th), tuple(d64(t) for t in data))[1])

    def launched(label, need):
        torch.cuda.synchronize()
        c, shapes = counts_now(kern)
        counts[label] = c
        emit({f"launches_{label}": c, "by_shape": shapes})
        for name in need:
            require(c[name] > 0, f"{label}: kernel {name} was not launched: {c}")
        return c

    # (0) kernel 1's forward-mode rule on the card (f32) against
    # torch.func.jvp over the plain version in f64 on the same inputs: the
    # first tangent and the nested one, at the derivative path's 8192² block
    # (D = 1) and at 2048² D = 2.  The f32 plain version's own error is
    # printed beside it: forward mode through its masked square root loses
    # digits at close pairs (1.8e-4 for Matern32 at D = 2 on the CPU, where
    # the rule reads 8e-7).  A Matern kernel's nested tangent jumps from its
    # limit to 0 where the distance is clamped (sq ≤ eps², which f32 and f64
    # place at different distances), so pairs closer than NEAR (ten f32
    # epsilons) are left out of its comparison, counted, and their error
    # printed on its own
    xf, xd, y, xp, theta = E.derivative_data(DERIV_N, DERIV_M, f32, dev)
    gen = torch.Generator(device="cpu").manual_seed(11)
    x2 = torch.randn(2048, 2, generator=gen).to(dev)
    y2 = torch.randn(2048, 2, generator=gen).to(dev)
    one = torch.tensor(1.0, dtype=f32, device=dev)
    jvp_rows = []
    routes = ((kernelmatrix, f32), (kernelmatrix_plain, f64), (kernelmatrix_plain, f32))
    for kind in ("se", "matern32"):
        for label, a0, b0 in (("D=1 8192x8192", xf[:, None], xd[:, None]),
                              ("D=2 2048x2048", x2, y2)):
            res = []
            for fn, dt in routes:
                aa, bb, vv = a0.to(dt), b0.to(dt), one.to(dt)
                first = jo(lambda b: fn(aa, b, kind, vv), bb)
                nested = jo(lambda a: jo(lambda b: fn(a, b, kind, vv), bb), aa)
                res.append((first.double(), nested.double()))
            dist = torch.cdist(a0.double(), b0.double(), compute_mode="donot_use_mm_for_euclid_dist")
            far = dist > (NEAR if kind != "se" else -1.0)
            row = {"kind": kind, "shape": label,
                   "first_max_abs_err": (res[0][0] - res[1][0]).abs().max().item(),
                   "nested_max_abs_err": ((res[0][1] - res[1][1]) * far).abs().max().item(),
                   "nested_max_abs": res[1][1].abs().max().item(),
                   "pairs_left_out": int((~far).sum().item()),
                   "nested_max_abs_err_left_out":
                       ((res[0][1] - res[1][1]) * ~far).abs().max().item(),
                   "plain_f32_nested_max_abs_err":
                       ((res[2][1] - res[1][1]) * far).abs().max().item()}
            jvp_rows.append(row)
            del res, dist, far
            require(row["first_max_abs_err"] <= JVP_TOL and row["nested_max_abs_err"] <= JVP_TOL,
                    f"kernel 1's jvp rule {kind} {label}: {row}")
    emit({"check": "kernelmatrix_jvp", "tolerance_abs": JVP_TOL, "cases": jvp_rows, "card": card})

    # (a) the gradient-enhanced GP: f and f′ observed jointly at N = 16384
    data = (xf, xd, y, xp)
    kern.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    val, grad = E.derivative_step(theta, data)
    a = launched("derivative_step", ("kernelmatrix", "chol_block", "tri_inv_block"))
    peak_step = torch.cuda.max_memory_allocated() / 2**30
    val64, grad64 = E.derivative_step(d64(theta), tuple(d64(t) for t in data))
    a_val, a_grad = abs(val.item() - val64.item()) / abs(val64.item()), grad_rel(grad, grad64)
    a_own = own_rel(grad, grad64)
    a_comp = components_at_low_condition(E.derivative_step, theta, data)
    # for scale, the same f32 step by the library's factor (cuSOLVER): the
    # gradient in the noise is a difference of two terms of order N/σ²
    # (0.5·tr K⁻¹ and 0.5·αᵀα), which f32 resolves to about cond·eps of them
    with stt.config.chol_backend("torch"):
        lib_val, lib_grad = E.derivative_step(theta, data)
    a_lib_val = abs(lib_val.item() - val64.item()) / abs(val64.item())
    a_lib_grad = grad_rel(lib_grad, grad64)
    # the marginals under one query noise in both dtypes (the default
    # jitter depends on the dtype); the posterior variance is the prior's
    # less a nearly equal term, so f32 cancels digits there: it is held to
    # 1e-3 of the prior variance, the means to 1e-3 of max|mean64|
    kern.reset_counters()
    ms = E.derivative_predict(theta, data, noise=PRED_NOISE)
    launched("derivative_predict", ("kernelmatrix", "chol_block", "tri_inv_block"))
    ms64 = E.derivative_predict(d64(theta), tuple(d64(t) for t in data), noise=PRED_NOISE)
    prior64 = E.build_derivative(d64(theta))
    blocks = [(k, sl) for k, sl in zip(("f", "df", "ddf"), torch.arange(3 * DERIV_M).split(DERIV_M))]
    mean_err = {k: rel(ms.mean[sl], ms64.mean[sl]) for k, sl in blocks}
    with stt.config.chol_backend("torch"):
        lib_ms = E.derivative_predict(theta, data, noise=PRED_NOISE)
    lib_mean_err = {k: rel(lib_ms.mean[sl], ms64.mean[sl]) for k, sl in blocks}
    del lib_ms
    var_err = {k: ((ms.var[sl].double() - ms64.var[sl]).abs().max()
                   / prior64[k].var(d64(xp)).max()).item() for k, sl in blocks}
    var_err_of_post = {k: rel(ms.var[sl], ms64.var[sl]) for k, sl in blocks}
    a_cond = cond_estimate(torch, E.derivative_observation(d64(theta), tuple(d64(t) for t in data)),
                           theta["noise"].item())
    del ms64, val64, grad64, prior64
    # the covariance's blocks, alone: K_ff (kernel 1), K_f,df (one jvp) and
    # K_df,df (a nested jvp); forward, and forward with the backward of ΣK
    g = E.build_derivative(theta)
    block_fns = {"K_ff": lambda p: p["f"].cov(xf),
                 "K_f_df": lambda p: stt.cross_cov(p["f"], p["df"], xf, xd),
                 "K_df_df": lambda p: p["df"].cov(xd)}
    block = {}
    for name, fn in block_fns.items():
        kern.reset_counters()
        with torch.no_grad():
            fn(g)
        torch.cuda.synchronize()
        launches = kern.COUNTERS["kernelmatrix"].total

        def fwd_bwd(fn=fn):
            leaves = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
            torch.autograd.grad(fn(E.build_derivative(leaves)).sum(), [leaves["v"], leaves["l"]])

        with torch.no_grad():
            fwd = host_ms(lambda: fn(g), reps=3)
        block[name] = {"fwd_ms": fwd, "fwd_bwd_ms": host_ms(fwd_bwd, reps=3),
                       "kernel1_launches": launches}
    fx = E.derivative_observation(theta, data)
    with torch.no_grad():
        K = fx.cov()
        block["factor"] = {"fwd_ms": host_ms(lambda: cholesky_psd(K), reps=3)}
    del K, fx, g
    out["derivative"] = {
        "n": DERIV_N, "m": DERIV_M, "dtype": "float32", "value_rel_err_f64": a_val,
        "grad_rel_err_f64": a_grad, "grad_own_rel_err_f64": a_own,
        f"grad_own_rel_err_f64_at_noise_{COMPONENT_NOISE}": a_comp,
        "library_f32_value_rel_err": a_lib_val, "library_f32_grad_rel_err": a_lib_grad,
        "mean_rel_err_f64": mean_err, "library_f32_mean_rel_err": lib_mean_err,
        "var_err_f64_of_prior_var": var_err, "var_rel_err_f64": var_err_of_post,
        "condition_estimate": a_cond,
        "step_ms": host_ms(lambda: E.derivative_step(theta, data), reps=3),
        "predict_ms": host_ms(lambda: E.derivative_predict(theta, data), reps=3),
        "blocks": block, "peak_step_gib": peak_step, "launches_step": a}
    emit({"derivative": out["derivative"]})
    emit({"profile_derivative_step": profile_ms(lambda: E.derivative_step(theta, data))})
    require(a_val <= 1e-4, f"derivative step f32 vs f64: value rel err {a_val} > 1e-4")
    require(a_grad <= DERIV_GRAD_TOL,
            f"derivative step f32 vs f64: gradient err {a_grad} > {DERIV_GRAD_TOL} (condition "
            f"about {a_cond:.3g}; cuSOLVER's f32 route {a_lib_grad})")
    for k, e in a_comp.items():
        require(e <= COMPONENT_TOL, f"derivative step at σ² = {COMPONENT_NOISE}: gradient in {k} "
                                    f"off by {e} of itself > {COMPONENT_TOL}")
    for k in mean_err:
        require(mean_err[k] <= 1e-3,
                f"derivative predict {k}: mean err {mean_err[k]} (of max|mean64|) > 1e-3 "
                f"(condition about {a_cond:.3g}; cuSOLVER's f32 route {lib_mean_err[k]})")
        require(var_err[k] <= 1e-3, f"derivative predict {k}: var err {var_err[k]} > 1e-3 of "
                                    "the prior variance")
    del data, xf, xd, y, xp, theta, ms
    torch.cuda.empty_cache()

    # (b) pathwise posterior samples of the flagship programme
    x, y, xp, th = E.flagship_data(N, M, f32, dev)
    kern.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    draws = E.pathwise_samples(th, x, y, xp, PW_S, PW_F)
    b = launched("pathwise", ("kernelmatrix", "chol_block", "tri_inv_block"))
    peak_pw = torch.cuda.max_memory_allocated() / 2**30
    draws64 = E.pathwise_samples(d64(th), d64(x), d64(y), d64(xp), PW_S, PW_F)
    pw_err = {k: rel(draws[k], draws64[k]) for k in draws}
    coherent = {"float32": rel(draws["f1"] + draws["f2"], draws["f3"].double()),
                "float64": rel(draws64["f1"] + draws64["f2"], draws64["f3"])}
    m_pred, _ = E.predict(th, x, y, xp)
    s_mean, s_sd = draws["f1"].mean(0), draws["f1"].std(0)
    mc = (s_mean - m_pred).abs() / (s_sd / math.sqrt(PW_S))
    mc_slack = 1e-3 * m_pred.abs().max().item()
    mc_ok = bool(((s_mean - m_pred).abs() <= 5 * s_sd / math.sqrt(PW_S) + mc_slack).all())
    out["pathwise"] = {"n": N, "m": M, "samples": PW_S, "features": PW_F, "dtype": "float32",
                       "rel_err_f64": pw_err, "f1_plus_f2_vs_f3": coherent,
                       "mean_vs_predict_max_z": mc.max().item(),
                       "sample_ms": host_ms(lambda: E.pathwise_samples(th, x, y, xp, PW_S, PW_F),
                                            reps=3),
                       "peak_gib": peak_pw, "launches": b}
    emit({"pathwise": out["pathwise"]})
    for k, e in pw_err.items():
        require(e <= 1e-3, f"pathwise {k} f32 vs f64: {e} > 1e-3 of max|draw64|")
    # f3 and f1 + f2 are two evaluations, each a sum over N = 16384 terms
    require(coherent["float64"] <= 1e-9 and coherent["float32"] <= 1e-3,
            f"pathwise: f1 + f2 differs from f3 beyond rounding: {coherent}")
    require(mc_ok, "pathwise: the draws' mean of f1 is not within 5 Monte-Carlo standard errors "
                   f"(+ {mc_slack}) of predict's posterior mean")
    del draws, draws64, x, y, xp, th
    torch.cuda.empty_cache()

    # (c) deconvolution: Cf observed at N = 16384, the latent read at 1024
    cx, cy, cxp, cth = E.deconvolution_data(N, M, DECONV_Q, f32, dev)
    cdata = (cx, cy, cxp)
    kern.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    val, grad = E.deconvolution_step(cth, cdata)
    c = launched("deconvolution_step", ("kernelmatrix", "chol_block", "tri_inv_block"))
    peak_c = torch.cuda.max_memory_allocated() / 2**30
    val64, grad64 = E.deconvolution_step(d64(cth), tuple(d64(t) for t in cdata))
    c_val, c_grad = abs(val.item() - val64.item()) / abs(val64.item()), grad_rel(grad, grad64)
    c_own = own_rel(grad, grad64)
    c_comp = components_at_low_condition(E.deconvolution_step, cth, cdata)
    with stt.config.chol_backend("torch"):
        c_lib_grad = grad_rel(E.deconvolution_step(cth, cdata)[1], grad64)
    cms = E.deconvolution_predict(cth, cdata, noise=PRED_NOISE)
    cms64 = E.deconvolution_predict(d64(cth), tuple(d64(t) for t in cdata), noise=PRED_NOISE)
    c_cond = cond_estimate(torch, E.build_deconvolution(d64(cth))(
        stt.GPPPInput("Cf", cx.double()), cth["noise"].item()), cth["noise"].item())
    c_mean = {k: rel(cms.mean[sl], cms64.mean[sl])
              for k, sl in zip(("f", "Cf"), torch.arange(2 * M).split(M))}
    out["deconvolution"] = {
        "n": N, "m": M, "nodes": DECONV_Q, "dtype": "float32", "value_rel_err_f64": c_val,
        "grad_rel_err_f64": c_grad, "library_f32_grad_rel_err": c_lib_grad,
        "grad_own_rel_err_f64": c_own, f"grad_own_rel_err_f64_at_noise_{COMPONENT_NOISE}": c_comp,
        "mean_rel_err_f64": c_mean, "condition_estimate": c_cond,
        "step_ms": host_ms(lambda: E.deconvolution_step(cth, cdata), reps=3),
        "predict_ms": host_ms(lambda: E.deconvolution_predict(cth, cdata), reps=3),
        "peak_step_gib": peak_c, "launches_step": c}
    emit({"deconvolution": out["deconvolution"]})
    require(c_val <= 1e-4, f"deconvolution step f32 vs f64: value rel err {c_val} > 1e-4")
    require(c_grad <= 5e-3,
            f"deconvolution step f32 vs f64: gradient err {c_grad} > 5e-3 (condition "
            f"about {c_cond:.3g}; cuSOLVER's f32 route {c_lib_grad})")
    for k, e in c_comp.items():
        require(e <= COMPONENT_TOL, f"deconvolution step at σ² = {COMPONENT_NOISE}: gradient in "
                                    f"{k} off by {e} of itself > {COMPONENT_TOL}")
    for k, e in c_mean.items():
        require(e <= 1e-3, f"deconvolution predict {k}: mean {e} > 1e-3 of max|mean64|")
    del cms, cms64, cdata, cx, cy, cxp, cth
    torch.cuda.empty_cache()

    # (d) the NKN: the example's own run (144 points, f64, 120 Adam steps,
    # its checks), then one step at N = 8192 against f64
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex = E.nkn_example(NKN_STEPS, device=dev)
    ex["seconds"] = time.perf_counter() - t0
    emit({"nkn_example": ex})
    nx, ny, n_train, period = E.nkn_data(NKN_N, f32, dev)
    spec = E.nkn_spec(nx[:n_train], period)
    theta0, _ = P.init(spec)
    kern.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    val, grad = E.nkn_step(theta0, nx, ny, spec)
    d = launched("nkn_step", ("kernelmatrix",))
    peak_n = torch.cuda.max_memory_allocated() / 2**30
    val64, grad64 = E.nkn_step(theta0.double(), nx.double(), ny.double(),
                               E.nkn_spec(nx[:n_train].double(), period))
    n_val = abs(val.item() - val64.item()) / abs(val64.item())
    n_grad = ((grad.double() - grad64).abs().max() / grad64.abs().max()).item()
    with stt.config.chol_backend("torch"):
        n_lib_grad = ((E.nkn_step(theta0, nx, ny, spec)[1].double() - grad64).abs().max()
                      / grad64.abs().max()).item()
    out["nkn"] = {"n": NKN_N, "dtype": "float32", "value_rel_err_f64": n_val,
                  "grad_rel_err_f64": n_grad, "library_f32_grad_rel_err": n_lib_grad,
                  "parameters": int(theta0.numel()),
                  "step_ms": host_ms(lambda: E.nkn_step(theta0, nx, ny, spec), reps=3),
                  "peak_step_gib": peak_n, "launches_step": d}
    emit({"nkn": out["nkn"]})
    require(n_val <= 1e-4, f"NKN step f32 vs f64: value rel err {n_val} > 1e-4")
    require(n_grad <= 5e-3, f"NKN step f32 vs f64: gradient err {n_grad} > 5e-3")
    del nx, ny, spec, theta0
    torch.cuda.empty_cache()

    # the examples differentiation.py and quadrature_convolution.py at
    # their own sizes (f64), with their own checks
    emit({"differentiation_example": E.differentiation_example(dev),
          "quadrature_convolution_example": E.quadrature_convolution_example(dev)})
    return counts, jvp_rows


def parallel_path(torch, dev, card, nuts_ref=None, smc_ref=None):
    """Phase 12: the distributed tier (`stheno_tpu_torch.parallel`) on a
    one-rank 'rows' mesh: NCCL on the card (gloo on the CPU, for a
    rehearsal), each part against f64 on the card.  `nuts_ref` and
    `smc_ref` are phase 10's unsharded runs of the NUTS example and the SE
    model's SMC (run here when not given).  Returns each distributed path's
    launch counts, by path."""
    import numpy as np
    import torch.distributed as dist

    import stheno_tpu_torch as stt
    from stheno_tpu_torch import cuda as kern
    from stheno_tpu_torch import entry as E
    from stheno_tpu_torch import params as P
    from stheno_tpu_torch import perf_probe as pp
    from stheno_tpu_torch.cuda.kernelmatrix import kernelmatrix_forward, kernelmatrix_plain
    from stheno_tpu_torch.inference import SVGP, BernoulliLikelihood, svgp_elbo, svgp_init
    from stheno_tpu_torch.kernels import Matern32Kernel, SEKernel, with_lengthscale
    from stheno_tpu_torch.parallel import (
        big_gp_logpdf, chains_mesh, data_mesh, distributed_mvn_logpdf, multihost,
        ring_posterior_mean_var,
        rows_mesh, run_nuts_sharded, run_smc_sharded, shard_rows, sharded_cov, sharded_logpdf,
        sharded_posterior, sharded_rand, svgp_elbo_dp)
    from stheno_tpu_torch.parallel import collectives as coll
    from stheno_tpu_torch.parallel.ring import ring_gp_logpdf

    f32, f64 = torch.float32, torch.float64
    out = {"card": card}
    counts = {}
    store = Path(__file__).resolve().parent / "build" / "dist_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    # the group: one rank, a file store, the card as its device; a failed
    # NCCL initialisation raises (nothing falls back to gloo)
    multihost.initialize(f"file://{store}", num_processes=1, process_id=0, device_type=dev.type)
    require(dist.get_world_size() == 1 and dist.get_backend() == ("nccl" if dev.type == "cuda"
                                                                  else "gloo"),
            f"phase 12's group: {dist.get_backend()} over {dist.get_world_size()} ranks")
    mesh = rows_mesh(device_type=dev.type)
    t_phase = time.perf_counter()

    def reset():
        torch.cuda.synchronize()
        kern.reset_counters()
        coll.reset_counters()

    def read(path, need=("kernelmatrix",)):
        """The kernels' launches and the collectives' calls since `reset`."""
        torch.cuda.synchronize()
        c, shapes = counts_now(kern)
        cc = {k: v.total for k, v in coll.COUNTERS.items()}
        counts[path] = c
        emit({f"parallel_{path}_launches": c, "launches_by_shape": shapes, "collectives": cc})
        for name in need:
            require(c[name] > 0, f"kernel {name} was not launched on the distributed path {path}")
        require(sum(cc.values()) > 0, f"no collective ran on the distributed path {path}")
        return c, cc

    def rel(a, b):
        return abs(a - b) / abs(b)

    def grad_err(g, g64):
        """Max error over every gradient component, of the largest."""
        a = torch.cat([g[k].double().reshape(-1) for k in g64])
        b = torch.cat([g64[k].double().reshape(-1) for k in g64])
        return ((a - b).abs().max() / b.abs().max()).item()

    def max_err(a, b):
        return (a.double() - b.double()).abs().max().item()

    try:
        # (a) the flagship through the distributed route, N = 16384 f32
        x, y, _, theta = E.flagship_data(N, 1, f32, dev)

        def dist_step(th):
            leaves = {k: v.detach().requires_grad_(True) for k, v in th.items()}
            fx = E.build(leaves)(stt.GPPPInput("f3", x), leaves["noise"])
            val = -sharded_logpdf(mesh, fx, y)
            return val.detach(), dict(zip(leaves, torch.autograd.grad(val, list(leaves.values()))))

        reset()
        torch.cuda.reset_peak_memory_stats()
        val, grad = dist_step(theta)
        dist_peak = torch.cuda.max_memory_allocated() / 2**30
        c_a, cc_a = read("flagship_step")
        single_step, _ = E.flagship(N, f32, dev)
        sval, sgrad = single_step(theta)
        # f64: the plain kernel matrix, torch.linalg.cholesky and autograd
        th64 = {k: v.detach().to(f64).requires_grad_(True) for k, v in theta.items()}
        x64, y64 = x.to(f64), y.to(f64)
        K64 = kernelmatrix_plain((x64 / th64["l1"])[:, None], None, "se", th64["v1"])
        K64 = K64 + kernelmatrix_plain((x64 / th64["l2"])[:, None], None, "matern32", 1.0)
        K64 = K64 + th64["noise"] * torch.eye(N, dtype=f64, device=dev)
        L64 = torch.linalg.cholesky(K64)
        a64 = torch.linalg.solve_triangular(L64, y64[:, None], upper=False)[:, 0]
        ref = 0.5 * (a64 @ a64) + torch.log(torch.diagonal(L64)).sum() + 0.5 * N * math.log(2 * math.pi)
        ref_grad = dict(zip(th64, torch.autograd.grad(ref, list(th64.values()))))
        del K64, L64, a64
        ref = ref.item()
        torch.cuda.empty_cache()
        dist_ms = host_ms(lambda: dist_step(theta), reps=3)
        single_ms = host_ms(lambda: single_step(theta), reps=3)
        emit({"profile_parallel_flagship_step": profile_ms(lambda: dist_step(theta))})
        with torch.no_grad():
            th = {k: v.detach() for k, v in theta.items()}
            kernel = (th["v1"] * with_lengthscale(SEKernel(), th["l1"])
                      + with_lengthscale(Matern32Kernel(), th["l2"]))
            reset()
            lp_big = big_gp_logpdf(mesh, kernel, x, y, th["noise"], block_size=128).item()
            read("big_gp_logpdf")
            K_loc = sharded_cov(mesh, E.build(th)(stt.GPPPInput("f3", x), th["noise"]))
            zeros = torch.zeros_like(y)
            reset()
            lp_mvn = distributed_mvn_logpdf(mesh, K_loc, zeros, y, block_size=1024).item()
            read("mvn_logpdf", need=())
            big_ms = host_ms(lambda: big_gp_logpdf(mesh, kernel, x, y, th["noise"], block_size=128),
                             reps=3)
            mvn_ms = host_ms(lambda: distributed_mvn_logpdf(mesh, K_loc, zeros, y, block_size=1024),
                             reps=3)
            del K_loc
        a = {"n": N, "dtype": "float32", "nlml_dist": val.item(), "nlml_single": sval.item(),
             "nlml_f64": ref, "value_rel_err_f64": rel(val.item(), ref),
             "value_rel_err_single": rel(val.item(), sval.item()),
             "grad_err_f64": grad_err(grad, ref_grad), "grad_err_single": grad_err(grad, sgrad),
             "single_grad_err_f64": grad_err(sgrad, ref_grad),
             "grad_dist": {k: g.item() for k, g in grad.items()},
             "grad_f64": {k: g.item() for k, g in ref_grad.items()},
             "dist_step_ms": dist_ms, "single_step_ms": single_ms, "peak_dist_step_gib": dist_peak,
             "kernel1_launches": c_a["kernelmatrix"], "collectives": cc_a,
             "big_gp_logpdf": {"block_size": 128, "value_rel_err_f64": rel(-lp_big, ref), "ms": big_ms},
             "mvn_logpdf": {"block_size": 1024, "value_rel_err_f64": rel(-lp_mvn, ref), "ms": mvn_ms},
             "value_tolerance": 1e-4, "grad_tolerance": 5e-3}
        out["a_flagship"] = a
        emit({"parallel_flagship": a})
        require(a["value_rel_err_f64"] <= 1e-4, f"distributed flagship value {a['value_rel_err_f64']}")
        require(a["grad_err_f64"] <= 5e-3, f"distributed flagship gradient {a['grad_err_f64']}")
        require(a["value_rel_err_single"] <= 1e-4 and a["grad_err_single"] <= 5e-3,
                "the distributed step does not match the single-card step")
        for key in ("big_gp_logpdf", "mvn_logpdf"):
            require(a[key]["value_rel_err_f64"] <= 1e-4, f"{key} value {a[key]['value_rel_err_f64']}")
        del th64, ref_grad, single_step
        torch.cuda.empty_cache()

        # (b) big_n_sharded's full-scale run: N = 32768, the composite
        # programme, the example's panel rule; f64 by cuSOLVER on the card
        nb = PAR_BIG_N
        bg = max(128, nb // 32)
        tb = {k: torch.tensor(v, dtype=f32, device=dev) for k, v in dict(v=1.5, l=1.0).items()}
        xg = torch.linspace(-10.0, 10.0, nb, dtype=f32, device=dev)
        xq = stt.GPPPInput("f1", torch.linspace(-8.0, 8.0, PAR_XP, dtype=f32, device=dev))
        with torch.no_grad():
            fxg = E.big_n_build(tb)(stt.GPPPInput("f3", xg), 0.1)
            reset()
            t0 = time.perf_counter()
            yg = sharded_rand(torch.Generator(device=dev).manual_seed(1), mesh, fxg, block_size=bg)
            torch.cuda.synchronize()
            rand_ms = (time.perf_counter() - t0) * 1e3
            read("big_n_rand")
            reset()
            torch.cuda.reset_peak_memory_stats()
            lp32 = sharded_logpdf(mesh, fxg, yg, block_size=bg).item()
            big_peak = torch.cuda.max_memory_allocated() / 2**30
            read("big_n_logpdf")
            logpdf_ms = host_ms(lambda: sharded_logpdf(mesh, fxg, yg, block_size=bg), reps=3)
            reset()
            t0 = time.perf_counter()
            m32, v32 = sharded_posterior(mesh, fxg, yg, block_size=bg).mean_and_var(xq)
            torch.cuda.synchronize()
            post_ms = (time.perf_counter() - t0) * 1e3
            read("big_n_posterior")
            torch.cuda.empty_cache()
            t64 = {k: v.to(f64) for k, v in tb.items()}
            xg64 = xg.to(f64)
            xq64 = stt.GPPPInput("f1", xq.x.to(f64))
            g64 = E.big_n_build(t64)
            fx64 = g64(stt.GPPPInput("f3", xg64), 0.1)
            m_obs = fx64.mean()
            L64 = torch.linalg.cholesky(fx64.cov())
            z = torch.linalg.solve_triangular(L64, (yg.to(f64) - m_obs)[:, None], upper=False)[:, 0]
            lp64 = (-0.5 * (nb * math.log(2 * math.pi) + 2 * torch.log(torch.diagonal(L64)).sum()
                            + z @ z)).item()
            Kox = g64.cov2(stt.GPPPInput("f3", xg64), xq64)
            alpha = torch.linalg.solve_triangular(L64.T, z[:, None], upper=True)[:, 0]
            mean64 = g64.mean(xq64) + Kox.T @ alpha
            A = torch.linalg.solve_triangular(L64, Kox, upper=False)
            var64 = g64.var(xq64) - (A * A).sum(0)
            del L64, Kox, A, fx64
        n_z = z.numel()
        zm, zv = z.mean().item(), z.var(unbiased=False).item()
        b = {"n": nb, "block_size": bg, "logpdf_f32": lp32, "logpdf_f64": lp64,
             "value_rel_err": rel(lp32, lp64), "mean_max_abs_err": max_err(m32, mean64),
             "mean_tolerance": 1e-3 * mean64.abs().max().item(), "var_max_abs_err": max_err(v32, var64),
             "var_tolerance": 1e-3 * 1.5, "rand_whitened": {"values": n_z, "mean": zm, "var": zv,
                                                           "mean_tolerance": 5 / math.sqrt(n_z),
                                                           "var_tolerance": 5 * math.sqrt(2 / n_z)},
             "logpdf_ms": logpdf_ms, "posterior_ms": post_ms, "rand_ms": rand_ms,
             "peak_logpdf_gib": big_peak, "card": card}
        out["b_big_n"] = b
        emit({"parallel_big_n_sharded": b})
        require(b["value_rel_err"] <= 1e-4, f"N = {nb} sharded logpdf value {b['value_rel_err']}")
        require(b["mean_max_abs_err"] <= b["mean_tolerance"], f"N = {nb} posterior mean {b}")
        require(b["var_max_abs_err"] <= b["var_tolerance"], f"N = {nb} posterior var {b}")
        require(bool(torch.isfinite(z).all()) and abs(zm) <= 5 / math.sqrt(n_z)
                and abs(zv - 1) <= 5 * math.sqrt(2 / n_z), f"N = {nb} sharded_rand whitened {zm}, {zv}")
        del fxg, yg, m32, v32, mean64, var64, z
        torch.cuda.empty_cache()

        # (c) the matrix-free ring: the reference probe's ring_p1 settings
        # (1.5·SE(1.0), noise 1.0) at N = 16384, and the posterior at N = 32768
        kr = 1.5 * with_lengthscale(SEKernel(), 1.0)
        xr = torch.linspace(-5.0, 5.0, N, dtype=f32, device=dev)
        yr = torch.sin(xr)
        x_sh, y_sh = shard_rows(mesh, xr), shard_rows(mesh, yr)

        def ring_lp(seed, yy):
            return ring_gp_logpdf(mesh, kr, x_sh, yy, 1.0, torch.Generator(device=dev).manual_seed(seed),
                                  **pp.RING_P1)

        reset()
        yy = y_sh.detach().clone().requires_grad_(True)
        lp_r = ring_lp(0, yy)
        (gy,) = torch.autograd.grad(lp_r, yy)
        read("ring_logpdf")
        with torch.no_grad():
            scatter = [ring_lp(s, y_sh).item() for s in range(1, PAR_RING_SEEDS + 1)]
            ring_ms = host_ms(lambda: ring_lp(0, y_sh), reps=3)
            xr64 = xr.to(f64)[:, None].contiguous()
            Kr = kernelmatrix_forward(xr64, None, "se", torch.tensor(1.5, dtype=f64, device=dev))
            Kr.diagonal().add_(1.0)
            lam_bound = Kr.abs().sum(1).max().item()  # ≥ λmax (Gershgorin); λmin ≥ 1
            Lr = torch.linalg.cholesky(Kr)
            del Kr
            zr = torch.linalg.solve_triangular(Lr, yr.to(f64)[:, None], upper=False)
            lp_dense = (-0.5 * (N * math.log(2 * math.pi) + 2 * torch.log(torch.diagonal(Lr)).sum()
                                + (zr * zr).sum())).item()
            alpha_r = torch.linalg.solve_triangular(Lr.T, zr, upper=True)[:, 0]
            del Lr, zr
        ygrad_tol = pp.RING_YGRAD_RTOL
        spread = float(np.std(scatter + [lp_r.item()], ddof=1))
        c = {"n": N, "settings": pp.RING_P1, "logpdf_ring": lp_r.item(), "logpdf_dense_f64": lp_dense,
             "abs_err": abs(lp_r.item() - lp_dense), "slq_seeds": scatter, "slq_std": spread,
             "value_tolerance": 5 * spread, "value_rel_err": rel(lp_r.item(), lp_dense),
             "ygrad_rel_err": max_err(gy, -alpha_r) / alpha_r.abs().max().item(),
             "ygrad_tolerance": ygrad_tol, "cond_bound": lam_bound, "logpdf_ms": ring_ms}
        require(c["abs_err"] <= c["value_tolerance"],
                f"ring logpdf {lp_r.item()} vs dense {lp_dense}: beyond 5 SLQ standard deviations")
        require(c["ygrad_rel_err"] <= ygrad_tol, f"ring y-gradient {c['ygrad_rel_err']} > {ygrad_tol}")
        del gy, yy, alpha_r
        xp_ = torch.linspace(-5.0, 5.0, PAR_BIG_N, dtype=f32, device=dev)
        yp_ = torch.sin(xp_)
        xs = torch.linspace(-4.5, 4.5, PAR_XP, dtype=f32, device=dev)
        with torch.no_grad():
            reset()
            t0 = time.perf_counter()
            m_r, v_r, its = ring_posterior_mean_var(mesh, kr, shard_rows(mesh, xp_), shard_rows(mesh, yp_),
                                                    1.0, xs, tol=PAR_RING_POST_TOL, maxiter=400)
            torch.cuda.synchronize()
            ring_post_ms = (time.perf_counter() - t0) * 1e3
            read("ring_posterior")
            xp64 = xp_.to(f64)[:, None].contiguous()
            v15 = torch.tensor(1.5, dtype=f64, device=dev)
            Kp = kernelmatrix_forward(xp64, None, "se", v15)
            Kp.diagonal().add_(1.0)
            Lp = torch.linalg.cholesky(Kp)
            del Kp
            Ks = kernelmatrix_forward(xp64, xs.to(f64)[:, None].contiguous(), "se", v15)  # (N, Np)
            ap = torch.cholesky_solve(yp_.to(f64)[:, None], Lp)[:, 0]
            mp64 = Ks.T @ ap
            Ap = torch.linalg.solve_triangular(Lp, Ks, upper=False)
            vp64 = 1.5 - (Ap * Ap).sum(0)
            del Lp, Ks, Ap
        c.update(posterior={"n": PAR_BIG_N, "points": PAR_XP, "tol": PAR_RING_POST_TOL,
                            "cg_iters": list(its), "ms": ring_post_ms,
                            "mean_max_abs_err": max_err(m_r, mp64),
                            "mean_tolerance": 1e-3 * mp64.abs().max().item(),
                            "var_max_abs_err": max_err(v_r, vp64), "var_tolerance": 1e-3 * 1.5})
        out["c_ring"] = c
        emit({"parallel_ring": c})
        cp = c["posterior"]
        require(cp["mean_max_abs_err"] <= cp["mean_tolerance"], f"ring posterior mean {cp}")
        require(cp["var_max_abs_err"] <= cp["var_tolerance"], f"ring posterior var {cp}")
        del m_r, v_r, mp64, vp64
        torch.cuda.empty_cache()

        # (d) svgp_elbo_dp at phase 9's SVGP configuration (131072 points,
        # 2 × 2048 inducing points, a Bernoulli minibatch of 4096)
        dmesh = data_mesh(device_type=dev.type)
        data = E.pseudo_points_data(PP_N, PP_M, f32, dev)
        theta0, _ = P.init(E.pseudo_points_spec(data[2]))
        unflattens = {dt: P.init(E.pseudo_points_spec(data[2].to(dt)))[1] for dt in (f32, f64)}
        labels = (data[1] > 0).to(f32)
        lik = BernoulliLikelihood()
        scale = PP_N / PP_BATCH
        rng = np.random.default_rng(2)
        idx = torch.as_tensor(np.sort(rng.choice(PP_N, PP_BATCH, replace=False)), device=dev)
        gq = torch.Generator(device="cpu").manual_seed(3)
        q_mu0 = (0.1 * torch.randn(2 * PP_M, generator=gq, dtype=f64)).to(dev)
        q_sqrt0 = 0.9 * torch.eye(2 * PP_M, dtype=f64, device=dev)

        def svgp_neg(dt, dp):
            leaves = [a.detach().to(dt).requires_grad_(True) for a in (theta0, q_mu0, q_sqrt0)]
            t = unflattens[dt](leaves[0])
            f = E.build_pseudo_points(t)
            u = f(stt.BlockData(stt.GPPPInput("f1", t["z"]), stt.GPPPInput("f2", t["z"])),
                  E.PP_INDUCING_NOISE)
            fx = f(stt.GPPPInput("f3", data[0][idx].to(dt)), E.PP_INDUCING_NOISE)
            q = SVGP(u, leaves[1], leaves[2])
            yb = labels[idx].to(dt)
            v = -(svgp_elbo_dp(dmesh, q, fx, yb, scale=scale, likelihood=lik) if dp
                  else svgp_elbo(q, fx, yb, scale=scale, likelihood=lik))
            return v.item(), dict(zip(("theta", "q_mu", "q_sqrt"), torch.autograd.grad(v, leaves)))

        reset()
        dp32 = svgp_neg(f32, True)
        read("svgp_dp")
        sd32, dp64, sd64 = svgp_neg(f32, False), svgp_neg(f64, True), svgp_neg(f64, False)
        svgp_ms = host_ms(lambda: svgp_neg(f32, True), reps=3)
        d = {"n": PP_N, "inducing": 2 * PP_M, "batch": PP_BATCH,
             "dp_vs_single_f32": {"value": rel(dp32[0], sd32[0]), "grad": grad_err(dp32[1], sd32[1])},
             "dp_vs_single_f64": {"value": rel(dp64[0], sd64[0]), "grad": grad_err(dp64[1], sd64[1])},
             "f32_vs_f64": {"value": rel(dp32[0], dp64[0]), "grad": grad_err(dp32[1], dp64[1])},
             "tolerance": {"dp_vs_single_f32": 1e-6, "dp_vs_single_f64": 1e-12,
                           "f32_vs_f64_value": PP_VAL_TOL, "f32_vs_f64_grad": 5e-3},
             "step_ms": svgp_ms}
        out["d_svgp"] = d
        emit({"parallel_svgp": d})
        for key, tol in (("dp_vs_single_f32", 1e-6), ("dp_vs_single_f64", 1e-12)):
            require(d[key]["value"] <= tol and d[key]["grad"] <= tol, f"svgp_elbo_dp {key}: {d[key]}")
        require(d["f32_vs_f64"]["value"] <= PP_VAL_TOL and d["f32_vs_f64"]["grad"] <= 5e-3,
                f"svgp_elbo_dp f32 against f64: {d['f32_vs_f64']}")
        del data, dp32, sd32, dp64, sd64
        torch.cuda.empty_cache()

        # (e) the sharded samplers at P = 1 against the unsharded runs
        cmesh = chains_mesh(device_type=dev.type)
        n_s, chains_s, warm_s, samp_s = NUTS_SMALL
        data_s = E.nuts_data(n_s, f64, dev)
        ld, theta_n0, _ = E.nuts_logdensity(data_s)
        if nuts_ref is None:
            nuts_ref = E.nuts_run(warm_s, samp_s, chains_s, data=data_s, seed=NUTS_SEED).theta
        reset()
        t0 = time.perf_counter()
        draws, _ = run_nuts_sharded(NUTS_SEED, ld, theta_n0, cmesh, num_warmup=warm_s,
                                    num_samples=samp_s, num_chains=chains_s)
        torch.cuda.synchronize()
        nuts_s = time.perf_counter() - t0
        read("nuts_sharded", need=("kernelmatrix_batched",))
        smc_data = E.smc_data(50, f64, dev)
        init = E.smc_particles(SMC_PARTICLES, f64, dev)
        loglike = E.smc_loglike(E.SMC_BUILDS["SE"], smc_data)
        kw = dict(num_mcmc=5, hmc_step_size=0.25, hmc_num_steps=10)
        if smc_ref is None:
            smc_ref = E.smc_run(E.SMC_BUILDS["SE"], smc_data, num_particles=SMC_PARTICLES)
        reset()
        t0 = time.perf_counter()
        res = run_smc_sharded(5, loglike, E.smc_logprior, init, cmesh, **kw)
        torch.cuda.synchronize()
        smc_s = time.perf_counter() - t0
        read("smc_sharded", need=("kernelmatrix_batched",))
        e = {"nuts": {"chains": chains_s, "warmup": warm_s, "samples": samp_s, "seconds": nuts_s,
                      "bit_identical": bool(torch.equal(draws, nuts_ref))},
             "smc": {"particles": SMC_PARTICLES, "seconds": smc_s,
                     "bit_identical": bool(torch.equal(res.particles, smc_ref.particles)
                                           and torch.equal(res.log_evidence, smc_ref.log_evidence)),
                     "log_evidence": res.log_evidence.item()}}
        out["e_samplers"] = e
        emit({"parallel_samplers": e})
        require(e["nuts"]["bit_identical"], "run_nuts_sharded at P = 1 differs from run_nuts")
        require(e["smc"]["bit_identical"], "run_smc_sharded at P = 1 differs from run_smc")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    out["phase_s"] = time.perf_counter() - t_phase
    emit({"parallel_path": {"phase_s": out["phase_s"], "card": card}})
    return counts


def example_kernel_inputs(torch, dev):
    """Kernel 1's inputs at the shapes phase 13 gives it that no earlier
    phase does: D = 4 (deep kernel learning's MLP features at its full
    width), D = 9 (the convolutional GP's 3 × 3 patches against its
    inducing points), batched D = 9 (`var2`'s per-image patch matrices) and
    batched Matérn 5/2 in f64 (getting-started's NUTS over 4 chains)."""
    from stheno_tpu_torch.examples import convolutional_gp as CG
    from stheno_tpu_torch.examples import deep_kernel_learning as DK

    f32, f64 = torch.float32, torch.float64
    x, _ = DK.data(DKL_N, f32, dev)
    w = DK.init_weights(torch.Generator().manual_seed(0), f32, dev)
    with torch.no_grad():
        d4 = DK.apply(w, x).contiguous()
    imgs, z, _ = CG.full_data(KM_BATCH_IMAGES, CONV_H, CONV_M, f32, dev)
    patches = CG.extract_patches(imgs).contiguous()  # (64, 676, 9)
    grid = torch.linspace(-5.0, 5.0, 100, dtype=f64, device=dev)
    # four chains' inputs, each stretched by its own 1/l1
    m52 = (grid[None, :, None] / torch.tensor([0.4, 0.3, 0.5, 0.45], dtype=f64, device=dev)
           [:, None, None]).contiguous()
    return {"d4": d4, "d9": (patches.reshape(-1, 9)[:KM_D9_ROWS].contiguous(), z.contiguous()),
            "batched_d9": patches, "m52": m52}


def example_kernel_checks(torch, dev, inputs):
    """Phase 2's checks of kernel 1 at `example_kernel_inputs`' shapes,
    against its plain version on the same inputs.  Returns the largest
    error in f32."""
    from stheno_tpu_torch.cuda.kernelmatrix import (
        kernelmatrix_batched_forward, kernelmatrix_forward, kernelmatrix_plain)

    f32, f64 = torch.float32, torch.float64
    checks = []

    def hold(label, K, Kp, tol):
        err = (K - Kp).abs().max().item()
        checks.append({"case": label, "shape": list(K.shape), "max_abs_err": err, "tolerance_abs": tol})
        require(err <= tol, f"kernelmatrix {label}: max abs err {err} > {tol}")

    var = torch.tensor(1.7, dtype=f32, device=dev)
    d4 = inputs["d4"]
    hold(f"deep kernel features same {d4.shape[0]}^2 D=4 SE f32",
         kernelmatrix_forward(d4, None, "se", var), kernelmatrix_plain(d4, None, "se", var), KM_TOL)
    torch.cuda.empty_cache()
    x9, z9 = inputs["d9"]
    for dt, tol in ((f32, KM_TOL), (f64, KM_TOL64)):
        v = var.to(dt)
        hold(f"patches x inducing {x9.shape[0]}x{z9.shape[0]} D=9 SE {dt}".replace("torch.", ""),
             kernelmatrix_forward(x9.to(dt), z9.to(dt), "se", v),
             kernelmatrix_plain(x9.to(dt), z9.to(dt), "se", v), tol)
    xb = inputs["batched_d9"]
    yb = xb.clone()  # var2 pairs two tensors of equal values: a cross launch
    vb = torch.full((xb.shape[0],), 1.7, dtype=f32, device=dev)
    hold(f"batched var2 {tuple(xb.shape[:2]) + (xb.shape[1],)} D=9 SE f32",
         kernelmatrix_batched_forward(xb, yb, "se", vb), kernelmatrix_plain(xb, yb, "se", vb), KM_TOL)
    m52 = inputs["m52"]
    v52 = torch.tensor([0.04, 0.05, 0.03, 0.045], dtype=f64, device=dev)
    hold(f"batched NUTS chains {tuple(m52.shape[:2]) + (m52.shape[1],)} D=1 Matern52 f64 same",
         kernelmatrix_batched_forward(m52, None, "matern52", v52),
         kernelmatrix_plain(m52, None, "matern52", v52), KM_TOL64)
    emit({"check": "kernelmatrix at the examples' shapes", "cases": checks})
    torch.cuda.empty_cache()
    return max(c["max_abs_err"] for c in checks if "f32" in c["case"])


def _km_row(label, fn, plain, n_out, n_in, d, itemsize, flop_rate, launches):
    """Kernel 1's time beside its plain version's and its bound at one
    shape: the bytes (inputs read once, the output written once) or the
    operations (3D + 7 an element), whichever takes longer."""
    ms = event_ms(fn, reps=10)
    plain_ms = event_ms(plain, reps=3)
    t_write = n_out * itemsize / HBM_BYTES_PER_S * 1e3
    t_read = n_in * d * itemsize / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = bound((n_out + n_in * d) * itemsize, n_out * (3 * d + 7), flop_rate)
    return {"shape": label, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "output_write_ms": t_write, "coordinate_read_ms": t_read,
            "launches": launches}


def examples_path(torch, dev, card, inputs):
    """Phase 13: the ten examples the port runs as modules
    (`stheno_tpu_torch.examples`), each at its own size with its checks;
    then three at full width in f32 against f64 on the card: (a) sensor
    fusion (BASELINE #3) at N = 16384, (b) deep kernel learning at
    N = 16384, (c) the convolutional GP's patch-space VFE on 4096 images of
    28 × 28 with 512 inducing points; a profile of (c)'s step; and kernel 1
    timed at the shapes of `example_kernel_inputs`.  Returns kernel 1's
    rows at those shapes and each full-width step's launch counts."""
    import importlib

    import stheno_tpu_torch as stt
    from stheno_tpu_torch import cuda as kern
    from stheno_tpu_torch.cuda.kernelmatrix import (
        kernelmatrix_batched_forward, kernelmatrix_forward, kernelmatrix_plain)
    from stheno_tpu_torch.examples import MODULES
    from stheno_tpu_torch.examples import convolutional_gp as CG
    from stheno_tpu_torch.examples import deep_kernel_learning as DK
    from stheno_tpu_torch.examples import sensor_fusion as SF
    from stheno_tpu_torch.inputs import BlockData, GPPPInput

    f32, f64 = torch.float32, torch.float64
    t_phase = time.perf_counter()

    # (1) every example at its own size, with its own checks
    runs = {}
    for name in MODULES:
        module = importlib.import_module(f"stheno_tpu_torch.examples.{name}")
        kern.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        numbers = module.main(device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, shapes = counts_now(kern)
        runs[name] = {"seconds": seconds, "launches": counts}
        emit({"example": name, "seconds": seconds, "launches": counts,
              "batched_launches_by_shape": shapes["kernelmatrix_batched"], "numbers": numbers,
              "card": card})
        require(counts["kernelmatrix"] + counts["kernelmatrix_batched"] >= 1,
                f"example {name}: kernel 1 was not launched")
        if name == "convolutional_gp":
            # var2 of the 12 images: one batched launch of (12, 36, 36), D = 9
            batched = kern.COUNTERS["kernelmatrix_batched"].by_shape
            require(counts["kernelmatrix_batched"] >= 1 and all(s[0] == 12 and s[3] == 9 for s in batched),
                    f"convolutional_gp: var2 did not make one batched launch over its images: {batched}")
        if name == "getting_started":
            batched = kern.COUNTERS["kernelmatrix_batched"].by_shape
            require(any(s[:4] == (4, 100, 100, 1) for s in batched),
                    f"getting_started: NUTS did not launch kernel 1 batched over its 4 chains: {batched}")
    emit({"examples": {name: r["seconds"] for name, r in runs.items()},
          "examples_s": sum(r["seconds"] for r in runs.values()), "card": card})
    torch.cuda.empty_cache()

    def rel(a, b):
        return abs(a.item() - b.item()) / abs(b.item())

    def grad_rel(g, g64):
        return ((g.to(f64) - g64).abs().max() / g64.abs().max()).item()

    def step_launches():
        counts, shapes = counts_now(kern)
        for name in FLAGSHIP_KERNELS:
            require(counts[name] > 0, f"kernel {name} was not launched")
        return counts, shapes

    steps = {}

    # (2a) sensor fusion at N = 16384: y1 and y2 at 8192 points each
    x32, y32 = SF.full_data(SF_N_PER, f32, dev)
    x64 = BlockData(*(GPPPInput(b.p, b.x.to(f64)) for b in x32.blocks))
    y64 = y32.to(f64)  # the same f32-rounded inputs

    def sf_theta(dtype, **at):
        return {k: torch.tensor(at.get(k, v), dtype=dtype, device=dev, requires_grad=True)
                for k, v in SF.THETA.items()}

    def sf_step(dtype, x, y, **at):
        th = sf_theta(dtype, **at)
        val = SF.nlml(th, x, y)
        return val.detach(), torch.stack(torch.autograd.grad(val, list(th.values())))

    torch.cuda.synchronize()
    kern.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    v32, g32 = sf_step(f32, x32, y32)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts, shapes = step_launches()
    v64, g64 = sf_step(f64, x64, y64)
    # for scale, cuSOLVER's f32 route on the same inputs; and the step at
    # both noise scales SF_UNIT_SCALE, held to phase 3's 5e-3
    with stt.config.chol_backend("torch"):
        lib_v32, lib_g32 = sf_step(f32, x32, y32)
    unit = dict(s1=SF_UNIT_SCALE, s2=SF_UNIT_SCALE)
    _, gu32 = sf_step(f32, x32, y32, **unit)
    _, gu64 = sf_step(f64, x64, y64, **unit)
    xp = torch.linspace(-2.5, 12.5, SF_XP, dtype=f32, device=dev)
    th32 = {k: v.detach() for k, v in sf_theta(f32).items()}
    th64 = {k: v.detach() for k, v in sf_theta(f64).items()}
    ms32 = SF.predict(th32, x32, y32, xp)
    ms64 = SF.predict(th64, x64, y64, xp.to(f64))
    with torch.no_grad():
        prior_var = SF.model().var(SF.query(xp.to(f64))).max().item()
    sf = {"n": 2 * SF_N_PER, "nlml_f32": v32.item(), "nlml_f64": v64.item(), "nlml_rel_err": rel(v32, v64),
          "grad_f32": g32.tolist(), "grad_f64": g64.tolist(), "grad_err_of_largest": grad_rel(g32, g64),
          "grad_tolerance": SF_GRAD_TOL, "cusolver_f32_nlml_rel_err": rel(lib_v32, v64),
          "cusolver_f32_grad_err_of_largest": grad_rel(lib_g32, g64),
          f"grad_err_of_largest_at_noise_scales_{SF_UNIT_SCALE}": grad_rel(gu32, gu64),
          "predict_points": 3 * SF_XP,
          "mean_max_abs_err": (ms32.mean.to(f64) - ms64.mean).abs().max().item(),
          "mean_tolerance": 1e-3 * ms64.mean.abs().max().item(),
          "var_max_abs_err": (ms32.var.to(f64) - ms64.var).abs().max().item(),
          "var_tolerance": 1e-3 * prior_var, "peak_step_gib": peak, "launches": counts,
          "launches_by_shape": shapes}
    sf["step_ms"] = host_ms(lambda: sf_step(f32, x32, y32), reps=3)
    sf["predict_ms"] = host_ms(lambda: SF.predict(th32, x32, y32, xp), reps=3)
    emit({"sensor_fusion_full": sf, "card": card})
    require(sf["nlml_rel_err"] <= 1e-4, f"sensor fusion nlml rel err {sf['nlml_rel_err']} > 1e-4")
    require(sf["grad_err_of_largest"] <= SF_GRAD_TOL,
            f"sensor fusion gradient err {sf['grad_err_of_largest']} > {SF_GRAD_TOL}")
    unit_err = sf[f"grad_err_of_largest_at_noise_scales_{SF_UNIT_SCALE}"]
    require(unit_err <= 5e-3, f"sensor fusion at noise scales {SF_UNIT_SCALE}: gradient err {unit_err}")
    require(sf["mean_max_abs_err"] <= sf["mean_tolerance"], f"sensor fusion mean err {sf}")
    require(sf["var_max_abs_err"] <= sf["var_tolerance"], f"sensor fusion var err {sf}")
    steps["sensor_fusion"] = counts
    del x32, y32, x64, y64, ms32, ms64
    torch.cuda.empty_cache()

    # (2b) deep kernel learning at N = 16384: kernel 1 at D = 4 on the features
    x, y = DK.data(DKL_N, f32, dev)
    w0 = DK.init_weights(torch.Generator().manual_seed(0), f32, dev)

    def dkl_step(dtype):
        w = {k: v.to(dtype).requires_grad_(True) for k, v in w0.items()}
        p = {"w": w, "v": torch.tensor(1.0, dtype=dtype, device=dev, requires_grad=True),
             "noise": torch.tensor(0.2, dtype=dtype, device=dev, requires_grad=True)}
        val = DK.nlml(p, x.to(dtype), y.to(dtype))
        grads = torch.autograd.grad(val, [p["v"], p["noise"], *w.values()])
        return val.detach(), torch.cat([g.reshape(-1) for g in grads])

    torch.cuda.synchronize()
    kern.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    v32, g32 = dkl_step(f32)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts, shapes = step_launches()
    require(any(s[2] == 4 for s in kern.COUNTERS["kernelmatrix"].by_shape),
            "deep kernel learning: kernel 1 was not launched at D = 4")
    v64, g64 = dkl_step(f64)
    dkl = {"n": DKL_N, "weights": int(g32.numel()) - 2, "nlml_f32": v32.item(), "nlml_f64": v64.item(),
           "nlml_rel_err": rel(v32, v64), "grad_err_of_largest": grad_rel(g32, g64),
           "grad_largest_f64": g64.abs().max().item(), "peak_step_gib": peak, "launches": counts,
           "launches_by_shape": shapes}
    dkl["step_ms"] = host_ms(lambda: dkl_step(f32), reps=3)
    emit({"deep_kernel_learning_full": dkl, "card": card})
    require(dkl["nlml_rel_err"] <= 1e-4, f"deep kernel nlml rel err {dkl['nlml_rel_err']} > 1e-4")
    require(dkl["grad_err_of_largest"] <= 5e-3, f"deep kernel gradient err {dkl['grad_err_of_largest']}")
    steps["deep_kernel_learning"] = counts
    del x, y
    torch.cuda.empty_cache()

    # (2c) the convolutional GP's VFE on 4096 images of 28 × 28, M = 512 in
    # patch space, in chunks of CONV_CHUNK images under one autograd graph
    imgs, z, yc = CG.full_data(CONV_IMAGES, CONV_H, CONV_M, f32, dev)

    def conv_step(dtype):
        th = {k: torch.tensor(v, dtype=dtype, device=dev, requires_grad=True)
              for k, v in (("var", CONV_VAR), ("l", 1.0))}
        val = CG.neg_elbo(th, imgs.to(dtype), z.to(dtype), yc.to(dtype), chunk=CONV_CHUNK)
        return val.detach(), torch.stack(torch.autograd.grad(val, [th["var"], th["l"]]))

    torch.cuda.synchronize()
    kern.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    v32, g32 = conv_step(f32)
    torch.cuda.synchronize()
    peak32 = torch.cuda.max_memory_allocated() / 2**30
    counts, shapes = counts_now(kern)
    n_chunks = CONV_IMAGES // CONV_CHUNK
    batched = kern.COUNTERS["kernelmatrix_batched"].by_shape
    require(counts["kernelmatrix_batched"] > 0 and counts["kernelmatrix_batched"] % n_chunks == 0
            and all(s[0] == CONV_CHUNK and s[3] == 9 for s in batched),
            f"convolutional GP: var2 did not make one batched launch a chunk: {batched}")
    require(any(s[2] == 9 for s in kern.COUNTERS["kernelmatrix"].by_shape),
            "convolutional GP: kernel 1 was not launched at D = 9")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    v64, g64 = conv_step(f64)
    torch.cuda.synchronize()
    peak64 = torch.cuda.max_memory_allocated() / 2**30
    conv = {"images": CONV_IMAGES, "image": [CONV_H, CONV_H], "patch_rows": CONV_IMAGES * (CONV_H - 2) ** 2,
            "inducing": CONV_M, "chunk_images": CONV_CHUNK, "var": CONV_VAR, "l": 1.0,
            "neg_elbo_f32": v32.item(),
            "neg_elbo_f64": v64.item(), "neg_elbo_rel_err": rel(v32, v64), "grad_f32": g32.tolist(),
            "grad_f64": g64.tolist(), "grad_err_of_largest": grad_rel(g32, g64),
            "peak_step_gib_f32": peak32, "peak_step_gib_f64": peak64, "launches": counts,
            "launches_by_shape": shapes}
    conv["step_ms"] = host_ms(lambda: conv_step(f32), reps=3)
    emit({"convolutional_gp_full": conv, "card": card})
    require(conv["neg_elbo_rel_err"] <= 1e-4, f"convolutional GP -ELBO rel err {conv['neg_elbo_rel_err']}")
    require(conv["grad_err_of_largest"] <= 5e-3, f"convolutional GP gradient err {conv['grad_err_of_largest']}")
    emit({"profile_convolutional_gp_step": profile_ms(lambda: conv_step(f32))})
    steps["convolutional_gp"] = counts
    del imgs, z, yc
    torch.cuda.empty_cache()

    # (3) kernel 1 at the examples' shapes, timed beside its plain version
    v1 = torch.tensor(1.0, dtype=f32, device=dev)
    d4 = inputs["d4"]
    rows = {"d4": _km_row(
        f"same-input {d4.shape[0]}x{d4.shape[0]} D=4 SE f32",
        lambda: kernelmatrix_forward(d4, None, "se", v1), lambda: kernelmatrix_plain(d4, None, "se", v1),
        d4.shape[0] ** 2, d4.shape[0], 4, 4, FP32_FLOP_PER_S,
        steps["deep_kernel_learning"]["kernelmatrix"])}
    torch.cuda.empty_cache()
    x9, z9 = inputs["d9"]
    for dt, rate, key in ((f32, FP32_FLOP_PER_S, "d9"), (f64, FP64_FLOP_PER_S, "d9_f64")):
        a, b, v = x9.to(dt), z9.to(dt), v1.to(dt)
        rows[key] = _km_row(
            f"cross {a.shape[0]}x{b.shape[0]} D=9 SE {str(dt)[6:]}",
            lambda: kernelmatrix_forward(a, b, "se", v), lambda: kernelmatrix_plain(a, b, "se", v),
            a.shape[0] * b.shape[0], a.shape[0] + b.shape[0], 9, a.element_size(), rate,
            steps["convolutional_gp"]["kernelmatrix"])
    xb = inputs["batched_d9"]
    yb = xb.clone()
    vb = torch.ones(xb.shape[0], dtype=f32, device=dev)
    c, p = xb.shape[:2]
    rows["batched_d9"] = _km_row(
        f"batched ({c}, {p}, {p}) D=9 SE f32",
        lambda: kernelmatrix_batched_forward(xb, yb, "se", vb),
        lambda: kernelmatrix_plain(xb, yb, "se", vb), c * p * p, 2 * c * p, 9, 4, FP32_FLOP_PER_S,
        steps["convolutional_gp"]["kernelmatrix_batched"])
    emit({"kernelmatrix_examples": rows, "card": card})
    out = {"rows": rows, "steps": steps, "phase_s": time.perf_counter() - t_phase}
    emit({"examples_path": {"phase_s": out["phase_s"], "card": card}})
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import stheno_tpu_torch as stt
    from stheno_tpu_torch import cuda as kern
    from stheno_tpu_torch.cuda.chol_block import (
        _smem_bytes, chol_block, chol_block_plain, library_smem_bytes, tri_inv_block,
        tri_inv_block_plain)
    from stheno_tpu_torch import perf_probe as pp
    from stheno_tpu_torch.cuda.kernelmatrix import (
        kernelmatrix_forward, kernelmatrix_plain, km_se_d1, km_se_d1_plain)
    from stheno_tpu_torch import params as P
    from stheno_tpu_torch.entry import build, flagship, flagship_data, nlml, predict
    from stheno_tpu_torch import entry as E
    from stheno_tpu_torch.graph import Periodic
    from stheno_tpu_torch.markov import markov_gp_logpdf, markov_gp_posterior_marginals
    from stheno_tpu_torch.ops import chol as C

    # ---- 1. set-up: numerics policy, build, card ---------------------------
    numerics_policy(torch)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kern.build_all()
    build_s = time.perf_counter() - t0
    card = card_line()
    print(card, flush=True)
    emit({"build_s": build_s, "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. each kernel against its plain version on the card --------------
    f32 = torch.float32
    km_checks = []
    km_err_main = 0.0
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = []
    xs_main = torch.linspace(-5.0, 5.0, N, dtype=f32, device=dev)[:, None]
    xp_main = torch.linspace(-4.5, 4.5, M, dtype=f32, device=dev)[:, None]
    for kind in ("se", "matern12", "matern32", "matern52"):
        cases.append((kind, "main same", xs_main, None, True))
        cases.append((kind, "main cross", xp_main, xs_main, True))
        xr = (torch.rand(1000, 1, generator=gen) * 6 - 3).to(dev)
        yr = (torch.rand(777, 1, generator=gen) * 6 - 3).to(dev)
        cases.append((kind, "ragged cross D=1", xr, yr, False))
        ell = torch.tensor([0.5, 1.0, 2.0])
        x3 = (torch.randn(1500, 3, generator=gen) / ell).to(dev)
        y3 = (torch.randn(700, 3, generator=gen) / ell).to(dev)
        cases.append((kind, "ARD same D=3", x3, None, False))
        cases.append((kind, "ARD cross D=3", x3, y3, False))
        cases.append((kind, "f64 ARD cross D=3", x3.double(), y3.double(), False))
    # the Mauna Loa path's shapes: the seasonal term's 2-D embedding of the
    # CO₂ times (12288², D = 2) and the trend's cross block (12288 × 4096)
    ml_x_co2, _, ml_x_T, _ = E.mauna_loa_data(*ML_FULL, f32, dev)
    ml_d2 = Periodic(1.0)(ml_x_co2).contiguous()
    cases.append(("se", "mauna loa seasonal same D=2", ml_d2, None, "ml"))
    cases.append(("se", "mauna loa trend cross D=1", (0.1 * ml_x_co2)[:, None].contiguous(),
                  (0.1 * ml_x_T)[:, None].contiguous(), "ml"))
    # the pseudo-point path's shapes at its initial lengthscales (1.0): Kuu's
    # two 2048² same-input blocks (SE for f1, Matern52 for f2) and Kuf's
    # 2048 × 131072 cross block of z against x
    pp_x, _, pp_z = E.pseudo_points_data(PP_N, PP_M, f32, dev)
    pp_x, pp_z = pp_x[:, None].contiguous(), pp_z[:, None].contiguous()
    cases.append(("se", "pseudo-point Kuu same D=1", pp_z, None, "pp"))
    cases.append(("matern52", "pseudo-point Kuu same D=1", pp_z, None, "pp"))
    cases.append(("se", "pseudo-point Kuf cross D=1", pp_z, pp_x, "pp"))
    km_err_ml = km_err_pp = 0.0
    var = torch.tensor(1.7, dtype=f32, device=dev)
    for kind, label, x, y, main_shape in cases:
        K = kernelmatrix_forward(x, y, kind, var)
        Kp = kernelmatrix_plain(x, y, kind, var)
        err = (K - Kp).abs().max().item()
        diag_ok = y is not None or bool((K.diagonal() == var).all())
        km_checks.append({"kind": kind, "case": label, "shape": list(K.shape),
                          "max_abs_err": err, "diag_exact": diag_ok})
        require(err <= KM_TOL and diag_ok,
                f"kernelmatrix {kind} {label}: max abs err {err} > {KM_TOL} or diagonal not exact")
        if main_shape == "ml":
            km_err_ml = max(km_err_ml, err)
        elif main_shape == "pp":
            km_err_pp = max(km_err_pp, err)
        elif main_shape:
            km_err_main = max(km_err_main, err)
        del K, Kp
    del cases, pp_x, pp_z
    emit({"check": "kernelmatrix", "tolerance_abs": KM_TOL, "cases": km_checks})
    # the examples' shapes (phase 13): D = 4, D = 9, batched D = 9, and
    # batched Matern52 in f64
    ex_inputs = example_kernel_inputs(torch, dev)
    km_err_examples = example_kernel_checks(torch, dev, ex_inputs)

    # the flagship covariance's leading block: the main path's base blocks
    x, y, xp, theta = flagship_data(N, M, f32, dev)
    with torch.no_grad():
        fx = build(theta)(stt.GPPPInput("f3", x), theta["noise"])
        K_main = fx.cov()
    A256 = K_main[:256, :256].contiguous()[None]
    A_main4 = (K_main[:1024, :1024].reshape(4, 256, 4, 256)
               .diagonal(dim1=0, dim2=2).permute(2, 0, 1).contiguous())
    A_ragged = spd_blocks(torch, 3, 200, f32, dev, seed=1)
    A_card = spd_blocks(torch, SMS, 256, f32, dev, seed=2)  # one block per SM
    CHOL_TOL = 1e-4  # relative to max|L|: fp32 sweeps in two summation orders
    TRI_TOL = 1e-4   # relative to max|L⁻¹|
    # kernel 3 also on its own, independent of the plain version (which
    # follows its tile order): |M·tril(L) − I| relative to max|M|·max|tril(L)|
    # (fp32 sums of up to 288 terms; about 4e-7 measured on an H100)
    RESID_TOL = 1e-4
    chol_checks = []
    # kernel 2 pads to whole 32×32 tiles: one padded tile (n = 1), a tile and
    # a row (33), one row short (255) and its shared-memory limit (288)
    chol_cases = [("main (1, 256, 256)", A256), ("main (4, 256, 256)", A_main4),
                  ("ragged (3, 200, 200)", A_ragged), (f"card ({SMS}, 256, 256)", A_card)]
    chol_cases += [(f"tiles (2, {n}, {n})", spd_blocks(torch, 2, n, f32, dev, seed=3 + n))
                   for n in (1, 33, 255, 288)]
    for label, A in chol_cases:
        L = chol_block(A)
        Lp = chol_block_plain(A)
        rel = ((L - Lp).abs().max() / Lp.abs().max()).item()
        chol_checks.append({"case": label, "max_rel_err": rel,
                            "max_abs_err": (L - Lp).abs().max().item()})
        require(rel <= CHOL_TOL, f"chol_block {label}: rel err {rel} > {CHOL_TOL}")
    chol_err_main = max(c["max_abs_err"] for c in chol_checks[:2])
    emit({"check": "chol_block", "tolerance_rel": CHOL_TOL, "cases": chol_checks})
    # `fits` (and so the probe's choice of base case) reads a Python copy of
    # kernels 2 and 3's shared-memory sizes: it must agree with the library
    for name in ("chol_block", "tri_inv_block"):
        for n in (1, 33, 255, 256, 288, 289, 337, 338):
            require(_smem_bytes(name, n) == library_smem_bytes(name, n),
                    f"{name}: the Python copy of its shared-memory size differs at n = {n}")
    del chol_cases

    L4 = chol_block_plain(A_main4)
    L1 = L4[:1].contiguous()
    L_ragged = chol_block_plain(A_ragged)
    L_card = chol_block_plain(A_card)
    tri_checks = []
    # kernel 3 pads to whole tiles as kernel 2 does; it reads tril(L) only
    tri_cases = [("main (4, 256, 256)", L4), ("main (1, 256, 256)", L1),
                 ("ragged (3, 200, 200)", L_ragged), (f"card ({SMS}, 256, 256)", L_card)]
    tri_cases += [(f"tiles (2, {n}, {n})", chol_block_plain(spd_blocks(torch, 2, n, f32, dev, seed=3 + n)))
                  for n in (1, 33, 255, 288)]
    tri_cases.append(("garbage above the diagonal (4, 256, 256)",
                      L4 + torch.triu(torch.full_like(L4, 1e3), 1)))
    for label, Lb in tri_cases:
        Mk = tri_inv_block(Lb)
        Mp = tri_inv_block_plain(Lb)
        rel = ((Mk - Mp).abs().max() / Mp.abs().max()).item()
        eye = torch.eye(Lb.shape[-1], dtype=Lb.dtype, device=dev)
        resid = (Mk @ torch.tril(Lb) - eye).abs().max().item()
        resid_rel = resid / max(Mk.abs().max().item() * torch.tril(Lb).abs().max().item(), 1e-30)
        tri_checks.append({"case": label, "max_rel_err": rel,
                           "max_abs_err": (Mk - Mp).abs().max().item(),
                           "max_abs_MinvL_minus_I": resid, "MinvL_minus_I_rel": resid_rel})
        require(rel <= TRI_TOL, f"tri_inv_block {label}: rel err {rel} > {TRI_TOL}")
        require(resid_rel <= RESID_TOL,
                f"tri_inv_block {label}: |M·L − I| {resid} is {resid_rel} of max|M|·max|L| > {RESID_TOL}")
    tri_err_main = max(c["max_abs_err"] for c in tri_checks[:2])
    emit({"check": "tri_inv_block", "tolerance_rel": TRI_TOL, "MinvL_tolerance_rel": RESID_TOL,
          "cases": tri_checks})
    # each kernel's arithmetic is in a fixed order, so a repeat that differs
    # in any bit means its threads raced
    L_first, M_first = chol_block(A_card), tri_inv_block(L_card)
    for _ in range(20):
        require(torch.equal(chol_block(A_card), L_first), "chol_block repeats differ")
        require(torch.equal(tri_inv_block(L_card), M_first), "tri_inv_block repeats differ")
    emit({"check": "repeats bit-identical", "launches": 20, "shape": [SMS, 256, 256]})
    del A_card, L_card, L_first, M_first, A, L, Lp, Lb, Mk, Mp, tri_cases
    del K_main, fx
    torch.cuda.synchronize()

    # ---- 3. flagship value and gradient at N=16384 f32 ---------------------
    step, theta = flagship(N, f32, dev)
    kern.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    val, grad = step(theta)
    torch.cuda.synchronize()
    peak_step_gib = torch.cuda.max_memory_allocated() / 2**30
    step_counts = {k: c.total for k, c in kern.COUNTERS.items()}
    step_shapes = {k: {str(s): v for s, v in c.by_shape.items()} for k, c in kern.COUNTERS.items()}
    emit({"step_launches": step_counts, "step_launches_by_shape": step_shapes})
    for name in FLAGSHIP_KERNELS:
        require(step_counts[name] > 0, f"kernel {name} was not launched by the flagship step")
    require(math.isfinite(val.item()) and all(math.isfinite(g.item()) for g in grad.values()),
            "flagship step is not finite")

    # independent f64 check: plain kernel matrix, torch.linalg.cholesky, autograd
    f64 = torch.float64
    th64 = {k: v.detach().to(f64).requires_grad_(True) for k, v in theta.items()}
    x64 = x.to(f64)
    y64 = y.to(f64)

    def ref_cov(t):
        K = kernelmatrix_plain((x64 / t["l1"])[:, None], None, "se", t["v1"])
        K = K + kernelmatrix_plain((x64 / t["l2"])[:, None], None, "matern32", 1.0)
        return K + t["noise"] * torch.eye(N, dtype=f64, device=dev)

    K64 = ref_cov(th64)
    L64 = torch.linalg.cholesky(K64)
    a64 = torch.linalg.solve_triangular(L64, y64[:, None], upper=False)[:, 0]
    ref = 0.5 * (a64 @ a64) + torch.log(torch.diagonal(L64)).sum() + 0.5 * N * math.log(2 * math.pi)
    ref_grad = dict(zip(th64, torch.autograd.grad(ref, list(th64.values()))))
    del K64, L64
    val_rel = abs(val.item() - ref.item()) / abs(ref.item())
    grad_rel = {k: abs(grad[k].item() - ref_grad[k].item()) / abs(ref_grad[k].item())
                for k in grad}
    # measured on an H100 (700 W): about 3e-6 for the value, and 5e-4 to 6e-4
    # for v1, the largest of the gradient's errors
    VAL_TOL, GRAD_TOL = 1e-4, 5e-3
    emit({"flagship_check": {"nlml_f32": val.item(), "nlml_f64": ref.item(),
                             "nlml_rel_err": val_rel, "tolerance": VAL_TOL,
                             "grad_f32": {k: g.item() for k, g in grad.items()},
                             "grad_f64": {k: g.item() for k, g in ref_grad.items()},
                             "grad_rel_err": grad_rel, "grad_tolerance": GRAD_TOL}})
    require(val_rel <= VAL_TOL, f"nlml rel err {val_rel} > {VAL_TOL}")
    for k, e in grad_rel.items():
        require(e <= GRAD_TOL, f"gradient {k} rel err {e} > {GRAD_TOL}")
    del ref, ref_grad, th64
    torch.cuda.empty_cache()

    # ---- 4. predict at N=16384, M=1024 -------------------------------------
    theta_d = {k: v.detach() for k, v in theta.items()}
    kern.reset_counters()
    mean, var_p = predict(theta_d, x, y, xp)
    torch.cuda.synchronize()
    pred_counts = {k: c.total for k, c in kern.COUNTERS.items()}
    pred_shapes = {k: {str(s): v for s, v in c.by_shape.items()} for k, c in kern.COUNTERS.items()}
    emit({"predict_launches": pred_counts, "predict_launches_by_shape": pred_shapes})
    for name in FLAGSHIP_KERNELS:
        require(pred_counts[name] > 0, f"kernel {name} was not launched by predict")
    with torch.no_grad():
        t64 = {k: v.to(f64) for k, v in theta_d.items()}
        K64 = ref_cov(t64)
        L64 = torch.linalg.cholesky(K64)
        del K64
        xp64 = xp.to(f64)
        Kxo = kernelmatrix_plain((xp64 / t64["l1"])[:, None], (x64 / t64["l1"])[:, None],
                                 "se", t64["v1"])
        alpha = torch.cholesky_solve(y64[:, None], L64)[:, 0]
        mean64 = Kxo @ alpha
        A = torch.linalg.solve_triangular(L64, Kxo.T, upper=False)
        var64 = t64["v1"] - (A * A).sum(0) + stt.config.default_jitter(f32)
        del L64, A, Kxo
    mean_err = (mean.to(f64) - mean64).abs().max().item()
    var_err = (var_p.to(f64) - var64).abs().max().item()
    MEAN_TOL = 1e-3 * mean64.abs().max().item()
    VAR_TOL = 1e-3 * t64["v1"].item()
    emit({"predict_check": {"mean_max_abs_err": mean_err, "mean_tolerance": MEAN_TOL,
                            "var_max_abs_err": var_err, "var_tolerance": VAR_TOL,
                            "mean_range": [mean64.min().item(), mean64.max().item()],
                            "var_range": [var64.min().item(), var64.max().item()]}})
    require(bool(torch.isfinite(mean).all() and torch.isfinite(var_p).all()), "predict not finite")
    require(mean_err <= MEAN_TOL, f"predict mean err {mean_err} > {MEAN_TOL}")
    require(var_err <= VAR_TOL, f"predict var err {var_err} > {VAR_TOL}")
    torch.cuda.empty_cache()

    # ---- 5. the performance probe's path at N=16384 ------------------------
    kern.reset_counters()
    probe = pp.Probe(n=N, reps=2, device=dev)
    probe.run(PROBE_ROWS)
    torch.cuda.synchronize()
    probe_counts = {k: c.total for k, c in kern.COUNTERS.items()}
    emit({"probe_launches": probe_counts,
          "probe_launches_by_shape": {k: {str(s): v for s, v in c.by_shape.items()}
                                      for k, c in kern.COUNTERS.items()}})
    for name in PROBE_KERNELS:
        require(probe_counts[name] > 0, f"kernel {name} was not launched by the probe")
    require(not probe.failures, f"probe checks failed: {probe.failures}")
    res = probe.results
    # kernel 4 (km_pal) against its plain version (km_xla), same inputs
    K4 = km_se_d1(probe.x)
    K4p = km_se_d1_plain(probe.x)
    km4_err = (K4 - K4p).abs().max().item()
    require(km4_err <= KM_TOL and bool((K4.diagonal() == 1.5).all()),
            f"km_se_d1: max abs err {km4_err} > {KM_TOL} or diagonal not exact")
    del K4, K4p
    # 64 chained 256-blocks: kernel 2 against torch.linalg.cholesky
    CHAIN_TOL = 1e-5  # relative: Σ of 64 forcing scalars, each tr(A) to f32 rounding
    chain_rel = abs(res["base_chain_pal"]["scalar"] - res["base_chain_lax"]["scalar"]) / abs(
        res["base_chain_lax"]["scalar"])
    require(chain_rel <= CHAIN_TOL, f"base_chain: pal vs lax rel err {chain_rel} > {CHAIN_TOL}")
    # the reverse rule's three modes on chol_grad's K, at backward panels of
    # 2048: each against I and against the others (the gradient of ΣL² in K
    # is I).  The fused sweep at 4096 is the probe's own row, with its limit.
    K = probe.km(0)
    modes = {m: {"mode": m, "block": 2048} for m in ("rec", "iter", "fused")}
    grads = {m: pp.grad_of_sum_sq(K, 2048, 256, bwd)[1] for m, bwd in modes.items()}
    del K
    vs_identity = {m: pp.identity_distance(g) for m, g in grads.items()}
    between = {f"{a}-{b}": (grads[a] - grads[b]).abs().max().item()
               for a, b in (("rec", "iter"), ("iter", "fused"), ("rec", "fused"))}
    del grads
    emit({"probe_check": {
        "km_se_d1_max_abs_err": km4_err, "km_tolerance_abs": KM_TOL,
        "forcing_rel_err_vs_trK": {k: res[k]["rel_err"] for k in ("chol_cur", "chol_pal_all", "chol_btri")},
        "forcing_tolerance_rel": pp.CHOL_RTOL,
        "base_chain_pal_vs_lax_rel": chain_rel, "base_chain_tolerance_rel": CHAIN_TOL,
        "grad_max_abs_err_vs_I": vs_identity, "grad_max_abs_diff_between_modes": between,
        "grad_backward_block": 2048, "grad_tolerance_abs": pp.GRAD_ATOL,
        "fused4096_max_abs_err_vs_I": res["chol_grad_fused4096"]["grad_max_abs_err_vs_I"],
        "fused4096_tolerance_abs": res["chol_grad_fused4096"]["grad_atol"]}})
    for k, e in {**vs_identity, **between}.items():
        require(e <= pp.GRAD_ATOL, f"chol_grad {k}: max abs err {e} > {pp.GRAD_ATOL}")
    torch.cuda.empty_cache()

    # ---- 6. the state-space tier at N=10^6 ----------------------------------
    kern.reset_counters()
    mprobe = pp.Probe(n=8, reps=2, device=dev, markov_n=NM)
    torch.cuda.reset_peak_memory_stats()
    mprobe.run(("markov_1m",))
    torch.cuda.synchronize()
    peak_markov_gib = torch.cuda.max_memory_allocated() / 2**30
    # the tier is plain PyTorch: no kernel of the four is on its path
    emit({"markov_launches": {k: c.total for k, c in kern.COUNTERS.items()}})
    require(not mprobe.failures, f"markov probe checks failed: {mprobe.failures}")
    xm, ym = pp.markov_inputs(NM, f32, dev)

    def markov_value_and_grad(dtype, x_, y_):
        lv = torch.tensor([1.2, 5.0], dtype=dtype, device=dev, requires_grad=True)
        v = markov_gp_logpdf(pp.markov_kernel(lv), x_.to(dtype), y_.to(dtype), 0.1, dtype=dtype)
        (g,) = torch.autograd.grad(v, lv)
        return v.item(), g.tolist()

    # the same (f32-rounded) inputs in both precisions
    v32, g32 = markov_value_and_grad(f32, xm, ym)
    v64, g64 = markov_value_and_grad(f64, xm, ym)
    MARKOV_TOL = 5e-3  # relative, as tests/test_markov.py:154 allows f32
    m_val_rel = abs(v32 - v64) / abs(v64)
    m_grad_rel = max(abs(a - b) / abs(b) for a, b in zip(g32, g64))
    # N = 16384 against the dense f64 logpdf of the same Matern32 GP
    nd = N
    xd, yd = pp.markov_inputs(nd, f64, dev)
    with torch.no_grad():
        Kd = kernelmatrix_plain((xd / 5.0)[:, None], None, "matern32", torch.tensor(1.2, dtype=f64, device=dev))
        Kd.diagonal().add_(0.1)
        Ld = torch.linalg.cholesky(Kd)
        del Kd
        ad = torch.linalg.solve_triangular(Ld, yd[:, None], upper=False)[:, 0]
        dense = (-0.5 * (ad @ ad) - torch.log(torch.diagonal(Ld)).sum() - 0.5 * nd * math.log(2 * math.pi)).item()
        del Ld
        lv64 = torch.tensor([1.2, 5.0], dtype=f64, device=dev)
        d64 = markov_gp_logpdf(pp.markov_kernel(lv64), xd, yd, 0.1, dtype=f64).item()
        d32 = markov_gp_logpdf(pp.markov_kernel(lv64.float()), xd.float(), yd.float(), 0.1,
                               dtype=f32).item()
        DENSE_TOL64 = 1e-8  # relative: f64 scan against f64 Cholesky
        dense_rel64 = abs(d64 - dense) / abs(dense)
        dense_rel32 = abs(d32 - dense) / abs(dense)
        # posterior marginals of the N = 10^6 fit at 4096 sites, f32
        xs_m = torch.linspace(0.0, 4000.0, 4096, dtype=f32, device=dev)
        lv32 = torch.tensor([1.2, 5.0], dtype=f32, device=dev)
        post = lambda: markov_gp_posterior_marginals(pp.markov_kernel(lv32), xm, ym, 0.1,
                                                     x_star=xs_m, dtype=f32)
        mean_m, var_m = post()
        post_ms = host_ms(post, reps=2)
    markov_fwd_ms = mprobe.results[f"markov_fwd_{NM}"]["median_ms"]
    markov_grad_ms = mprobe.results[f"markov_grad_{NM}"]["median_ms"]
    # the least the filter can move: x and y read once, the per-step
    # elements (A, b, C, η, J: 16 floats for 2 states) written once and read
    # once by the scan, and the filtered moments (b, C: 6 floats) written once
    markov_bytes = NM * (2 + 2 * 16 + 6) * 4
    markov_bound, markov_by = bound(markov_bytes, 0)
    emit({"markov_check": {
        "n": NM, "logpdf_f32": v32, "logpdf_f64": v64, "logpdf_rel_err": m_val_rel,
        "grad_f32": g32, "grad_f64": g64, "grad_max_rel_err": m_grad_rel, "tolerance_rel": MARKOV_TOL,
        "dense_n": nd, "dense_f64_logpdf": dense, "markov_f64_logpdf": d64, "markov_f32_logpdf": d32,
        "dense_rel_err_f64": dense_rel64, "dense_tolerance_f64": DENSE_TOL64,
        "dense_rel_err_f32": dense_rel32, "dense_tolerance_f32": MARKOV_TOL,
        "posterior_sites": xs_m.shape[0], "var_range": [var_m.min().item(), var_m.max().item()]}})
    require(m_val_rel <= MARKOV_TOL and m_grad_rel <= MARKOV_TOL,
            f"markov f32 vs f64 at N={NM}: value {m_val_rel}, gradient {m_grad_rel} > {MARKOV_TOL}")
    require(dense_rel64 <= DENSE_TOL64, f"markov f64 vs dense: {dense_rel64} > {DENSE_TOL64}")
    require(dense_rel32 <= MARKOV_TOL, f"markov f32 vs dense: {dense_rel32} > {MARKOV_TOL}")
    require(bool(torch.isfinite(mean_m).all() and torch.isfinite(var_m).all() and (var_m > 0).all()),
            "markov posterior marginals are not finite and positive")
    emit({"markov": {"n": NM, "dtype": "float32", "fwd_ms": markov_fwd_ms, "grad_ms": markov_grad_ms,
                     "posterior_4096_ms": post_ms, "fwd_bound_ms": markov_bound,
                     "fwd_bound_by": markov_by, "fwd_bound_bytes": markov_bytes,
                     "peak_gib": peak_markov_gib, "card": card}})
    lv_p = torch.tensor([1.2, 5.0], dtype=f32, device=dev)

    def markov_grad_once():
        lv = lv_p.clone().requires_grad_(True)
        torch.autograd.grad(markov_gp_logpdf(pp.markov_kernel(lv), xm, ym, 0.1, dtype=f32), lv)

    with torch.no_grad():
        emit({"profile_markov_fwd": profile_ms(
            lambda: markov_gp_logpdf(pp.markov_kernel(lv_p), xm, ym, 0.1, dtype=f32))})
    emit({"profile_markov_grad": profile_ms(markov_grad_once)})
    del xm, ym, xd, yd, mean_m, var_m
    torch.cuda.empty_cache()

    # ---- 7. the extended Mauna Loa path --------------------------------------
    # (a) the example's own size, N = 840, f32: the small torch.linalg route,
    # kernel 1 only.  The example's 250 Adam steps at 3e-2 and its
    # assertions (`entry.mauna_loa_example`; in f32 its posterior is
    # queried under the f32 default jitter, the example's 1e-9 being below
    # f32's rounding)
    kern.reset_counters()
    ml_small = E.mauna_loa_example(250, 3e-2, f32, dev)
    torch.cuda.synchronize()
    fit_small_step_ms = ml_small["fit_s"] * 1e3 / 250
    fit_small_counts = {k: c.total for k, c in kern.COUNTERS.items()}
    emit({"mauna_loa_small": {**ml_small, "dtype": "float32", "learning_rate": 3e-2,
                              "fit_ms_per_step": fit_small_step_ms, "launches": fit_small_counts,
                              "card": card}})
    require(fit_small_counts["kernelmatrix"] > 0, "kernel 1 was not launched by the N = 840 fit")

    # (b) full size, N = 16384, f32, on the blocked route
    data = E.mauna_loa_data(*ML_FULL, f32, dev)
    data64 = tuple(t.to(f64) for t in data)  # the same f32-rounded inputs
    theta0, unflatten = P.init(E.mauna_loa_spec(f32, dev))
    kern.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    ml_val, ml_grad = E.mauna_loa_step(theta0, data)
    torch.cuda.synchronize()
    ml_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ml_counts = {k: c.total for k, c in kern.COUNTERS.items()}
    ml_shapes = {k: {str(s): v for s, v in c.by_shape.items()} for k, c in kern.COUNTERS.items()}
    emit({"mauna_loa_step_launches": ml_counts, "mauna_loa_step_launches_by_shape": ml_shapes})
    for name in FLAGSHIP_KERNELS:
        require(ml_counts[name] > 0, f"kernel {name} was not launched by the Mauna Loa step")
    require(any(s[2] == 2 for s in kern.COUNTERS["kernelmatrix"].by_shape),
            "kernel 1 was not launched at D = 2 by the Mauna Loa step")
    require(math.isfinite(ml_val.item()) and bool(torch.isfinite(ml_grad).all()),
            "Mauna Loa step is not finite")
    # f64 on the card: kernel 1 in f64 and the blocked factor on the
    # library's base cases (chosen by dtype)
    kern.reset_counters()
    ml_val64, ml_grad64 = E.mauna_loa_step(theta0.to(f64), data64)
    torch.cuda.synchronize()
    f64_counts = {k: c.total for k, c in kern.COUNTERS.items()}
    require(f64_counts["chol_block"] == 0 and f64_counts["tri_inv_block"] == 0,
            "the f64 step launched an f32 base-case kernel")
    ml_val_rel = abs(ml_val.item() - ml_val64.item()) / abs(ml_val64.item())
    ml_grad_rel = ((ml_grad.to(f64) - ml_grad64).abs().max() / ml_grad64.abs().max()).item()
    # for scale, the same f32 value by the library's factor (cuSOLVER), and
    # f64 arithmetic on the f32-rounded covariance: this covariance (a unit
    # constant kernel over 12288 points beside noise 0.01, condition about
    # 10⁶) takes f32 past the flagship's 1e-4 on any route (on an H100,
    # 700 W, the port read 2.5e-4 and cuSOLVER 1.6e-4), so the value is
    # held to ML_VAL_TOL
    with torch.no_grad():
        with stt.config.chol_backend("torch"):
            lib_val = E.mauna_loa_nlml(unflatten(theta0), data).item()
        x_ml, y_ml = E.mauna_loa_observations(data)
        t0_32 = unflatten(theta0)
        L_r = torch.linalg.cholesky(
            E.build_gp(t0_32)(x_ml, E.obs_noise(t0_32, *ML_FULL)).cov().to(f64))
        a_r = torch.linalg.solve_triangular(L_r, y_ml.to(f64)[:, None], upper=False)[:, 0]
        rounded_val = (0.5 * (a_r @ a_r) + torch.log(L_r.diagonal()).sum()
                       + 0.5 * N * math.log(2 * math.pi)).item()
        del L_r, a_r
    lib_val_rel = abs(lib_val - ml_val64.item()) / abs(ml_val64.item())
    rounded_val_rel = abs(rounded_val - ml_val64.item()) / abs(ml_val64.item())
    emit({"mauna_loa_check": {"n": N, "nlml_f32": ml_val.item(), "nlml_f64": ml_val64.item(),
                              "nlml_rel_err": ml_val_rel, "tolerance": ML_VAL_TOL,
                              "nlml_f32_cusolver_rel_err": lib_val_rel,
                              "nlml_f64_of_f32_rounded_cov_rel_err": rounded_val_rel,
                              "grad_f32": ml_grad.tolist(), "grad_f64": ml_grad64.tolist(),
                              "grad_max_err_rel_to_largest": ml_grad_rel, "grad_tolerance": GRAD_TOL,
                              "f64_launches": f64_counts}})
    require(ml_val_rel <= ML_VAL_TOL, f"Mauna Loa nlml rel err {ml_val_rel} > {ML_VAL_TOL}")
    require(ml_grad_rel <= GRAD_TOL, f"Mauna Loa gradient err {ml_grad_rel} > {GRAD_TOL} of the largest")
    torch.cuda.empty_cache()

    # 3 steps of fit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit3 = E.mauna_loa_fit(3, 3e-2, data=data)
    torch.cuda.synchronize()
    fit_full_step_ms = (time.perf_counter() - t0) * 1e3 / 3
    require(bool(torch.isfinite(fit3.losses).all()), f"Mauna Loa N=16384: fit losses {fit3.losses.tolist()}")
    emit({"mauna_loa_fit3_losses": fit3.losses.tolist()})
    params = fit3.params
    params64 = {k: ({kk: vv.to(f64) for kk, vv in v.items()} if isinstance(v, dict) else v.to(f64))
                for k, v in params.items()}

    # posterior marginals at 3 × 1024 points against f64
    xp_ml = torch.linspace(-22.0, 25.0, ML_XP, dtype=f32, device=dev)
    # the mean, like the value, carries f32's error on this covariance: the
    # port read 2.0e-3 of max|mean64| on an H100 (700 W), so it is held to
    # ML_MEAN_TOL of it, with cuSOLVER's f32 route beside it for scale; the
    # variance to 1e-3 of its largest f64 value
    ms = E.mauna_loa_predict(params, data, xp_ml)
    ms64 = E.mauna_loa_predict(params64, data64, xp_ml.to(f64))
    with stt.config.chol_backend("torch"):
        ms_lib = E.mauna_loa_predict(params, data, xp_ml)
    ml_mean_err = (ms.mean.to(f64) - ms64.mean).abs().max().item()
    ml_var_err = (ms.var.to(f64) - ms64.var).abs().max().item()
    lib_mean_err = (ms_lib.mean.to(f64) - ms64.mean).abs().max().item()
    lib_var_err = (ms_lib.var.to(f64) - ms64.var).abs().max().item()
    ML_MEAN_TOL = ML_MEAN_TOL_REL * ms64.mean.abs().max().item()
    ML_VAR_TOL = 1e-3 * ms64.var.abs().max().item()
    emit({"mauna_loa_predict_check": {"points": 3 * ML_XP, "mean_max_abs_err": ml_mean_err,
                                      "cusolver_f32_mean_max_abs_err": lib_mean_err,
                                      "cusolver_f32_var_max_abs_err": lib_var_err,
                                      "mean_range": [ms64.mean.min().item(), ms64.mean.max().item()],
                                      "mean_tolerance": ML_MEAN_TOL, "var_max_abs_err": ml_var_err,
                                      "var_tolerance": ML_VAR_TOL,
                                      "var_range": [ms64.var.min().item(), ms64.var.max().item()]}})
    require(bool(torch.isfinite(ms.mean).all() and torch.isfinite(ms.var).all()),
            "Mauna Loa predict not finite")
    require(ml_mean_err <= ML_MEAN_TOL, f"Mauna Loa predict mean err {ml_mean_err} > {ML_MEAN_TOL}")
    require(ml_var_err <= ML_VAR_TOL, f"Mauna Loa predict var err {ml_var_err} > {ML_VAR_TOL}")
    del ms64, ms_lib
    torch.cuda.empty_cache()

    # rand: 4 joint prior samples at N = 16384 and 16 posterior samples at
    # the 3 × 1024 points, whitened as the tests do: z = L⁻¹(y − m) must be
    # finite with mean and variance within 5σ of N(0, 1).  The prior
    # samples are whitened by the f64 factor of the same covariance (an
    # independent route); the posterior's by its own factor.  In f32 the
    # posterior covariance K − AᵀA is PSD only up to rounding, about
    # eps·‖K‖ (its extreme eigenvalues are printed), below the f32 default
    # jitter (1e-6), so the posterior is queried with ML_POST_NOISE (the
    # example's f64 query takes 1e-9)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        post_eigs = torch.linalg.eigvalsh(
            E.mauna_loa_posterior(params, data).cov(E.mauna_loa_query(xp_ml)).to(f64))
        fx_prior = E.build_gp(params)(x_ml, E.obs_noise(params, *ML_FULL))
        kern.reset_counters()
        ys_prior = stt.rand(gen, fx_prior, 4)
        torch.cuda.synchronize()
        rand_counts = {k: c.total for k, c in kern.COUNTERS.items()}
        fx64 = E.build_gp(params64)(E.mauna_loa_observations(data64)[0], E.obs_noise(params64, *ML_FULL))
        L64 = C.cholesky_psd(fx64.cov())
        z_prior = torch.linalg.solve_triangular(L64, ys_prior.to(f64) - fx64.mean()[:, None],
                                                upper=False)
        del L64, fx64
        fq = E.mauna_loa_posterior(params, data)(E.mauna_loa_query(xp_ml), ML_POST_NOISE)
        ys_post = stt.rand(gen, fq, 16)
        Lq = C.cholesky_psd(fq.cov()).to(f64)
        z_post = torch.linalg.solve_triangular(Lq, ys_post.to(f64) - fq.mean().to(f64)[:, None],
                                               upper=False)
    for name in FLAGSHIP_KERNELS:
        require(rand_counts[name] > 0, f"kernel {name} was not launched by rand at N = {N}")
    rand_checks = {}
    for label, z in (("prior", z_prior), ("posterior", z_post)):
        n_z = z.numel()
        zm, zv = z.mean().item(), z.var(unbiased=False).item()
        rand_checks[label] = {"values": n_z, "mean": zm, "var": zv, "mean_tolerance": 5 / math.sqrt(n_z),
                              "var_tolerance": 5 * math.sqrt(2 / n_z),
                              "finite": bool(torch.isfinite(z).all())}
        require(rand_checks[label]["finite"], f"rand {label}: whitened samples are not finite")
        require(abs(zm) <= 5 / math.sqrt(n_z), f"rand {label}: whitened mean {zm} beyond 5 sigma")
        require(abs(zv - 1) <= 5 * math.sqrt(2 / n_z), f"rand {label}: whitened var {zv} beyond 5 sigma")
    emit({"mauna_loa_rand_check": rand_checks, "rand_launches": rand_counts,
          "posterior_query_noise": ML_POST_NOISE,
          "posterior_cov_f32_eigenvalue_range": [post_eigs.min().item(), post_eigs.max().item()]})
    del z_prior, z_post, Lq, ys_post, fq, post_eigs

    ml_step_ms = host_ms(lambda: E.mauna_loa_step(theta0, data), reps=3)
    ml_predict_ms = host_ms(lambda: E.mauna_loa_predict(params, data, xp_ml), reps=3)
    with torch.no_grad():
        rand_ms = host_ms(lambda: stt.rand(gen, fx_prior, 4), reps=3)
    # the step's flops as the flagship's (N³); predict: the factor and two
    # triangular solves of an N × 3·1024 right-hand side
    ml_step_bound, _ = bound(0, N**3)
    emit({"mauna_loa": {"n": N, "n_co2": ML_FULL[0], "n_T": ML_FULL[1], "dtype": "float32",
                        "mauna_loa_step_ms": ml_step_ms, "mauna_loa_predict_ms": ml_predict_ms,
                        "predict_points": 3 * ML_XP, "rand_ms": rand_ms, "rand_samples": 4,
                        "fit_ms_per_step": fit_full_step_ms, "fit_small_ms_per_step": fit_small_step_ms,
                        "step_bound_ms": ml_step_bound, "peak_step_gib": ml_peak_gib,
                        "launches_by_kernel": ml_counts, "card": card}})
    emit({"profile_mauna_loa_step": profile_ms(lambda: E.mauna_loa_step(theta0, data))})
    del data, data64, fx_prior, ys_prior, ms, fit3, x_ml, y_ml
    torch.cuda.empty_cache()

    # ---- 8. timings --------------------------------------------------------
    step_ms = host_ms(lambda: step(theta), reps=5)
    predict_ms = host_ms(lambda: predict(theta_d, x, y, xp), reps=5)

    def assemble():
        with torch.no_grad():
            return build(theta_d)(stt.GPPPInput("f3", x), theta_d["noise"]).cov()

    def chol_fwd():
        with torch.no_grad():
            C.cholesky_psd(assemble())

    def chol_grad():
        K = assemble().requires_grad_(True)
        L = C.cholesky_psd(K)
        torch.autograd.grad(torch.sum(L * L), K)

    def logpdf_fwd():
        with torch.no_grad():
            nlml(theta_d, x, y)

    stages = {
        "km_ms": host_ms(assemble, reps=5),
        "chol_fwd_ms": host_ms(chol_fwd, reps=5),
        "chol_grad_ms": host_ms(chol_grad, reps=5),
        "logpdf_fwd_ms": host_ms(logpdf_fwd, reps=5),
    }

    # per-kernel device times at the main path's shapes
    xs = xs_main / 1.0
    v1 = torch.tensor(1.5, dtype=f32, device=dev)
    km_ms = event_ms(lambda: kernelmatrix_forward(xs, None, "se", v1), reps=20)
    km_plain_ms = event_ms(lambda: kernelmatrix_plain(xs, None, "se", v1), reps=5)
    km_bytes = (N * 1 + N * N) * 4
    km_flops = N * N * 10  # diff, square, scale, exp (~6), variance
    km_bound, km_by = bound(km_bytes, km_flops)

    A1 = A256
    ch_ms = event_ms(lambda: chol_block(A1), reps=50)
    ch_plain_ms = event_ms(lambda: chol_block_plain(A1), reps=3)
    ch_lib_ms = event_ms(lambda: torch.linalg.cholesky(A1), reps=50)
    # the same factor without the host sync on `info`
    ch_lib_ex_ms = event_ms(lambda: torch.linalg.cholesky_ex(A1), reps=50)
    # kernel 2 by block size: n = 32 is one diagonal tile (load, one warp's
    # factor, store), so the ladder shows what the tile columns add.  Back to
    # back (CUDA events) and the kernel's own device time (profiler)
    ch_by_n, ch_by_n_dev = {}, {}
    for n in (32, 64, 128, 256):
        An = spd_blocks(torch, 1, n, f32, dev, seed=n)
        ch_by_n[n] = event_ms(lambda: chol_block(An), reps=50)
        ch_by_n_dev[n] = device_ms(lambda: chol_block(An), "chol_block_kernel", reps=20)
    emit({"chol_block_by_n": {"by_n_ms": ch_by_n, "by_n_device_ms": ch_by_n_dev, "card": card}})
    # kernels 2 and 3 read a block's lower triangle and write the whole block
    blk_bytes = (256 * 257 // 2 + 256 * 256) * 4
    ch_bound, ch_by = bound(blk_bytes, 256**3 / 3)

    tri = {}
    for b, Lb in ((4, L4), (1, L1)):
        eye = torch.eye(256, dtype=f32, device=dev).expand(b, 256, 256)
        tri[b] = {
            "ms": event_ms(lambda: tri_inv_block(Lb), reps=50),
            "plain_ms": event_ms(lambda: tri_inv_block_plain(Lb), reps=3),
            "device_ms": device_ms(lambda: tri_inv_block(Lb), "tri_inv_kernel", reps=20),
            "library_ms": event_ms(
                lambda: torch.linalg.solve_triangular(Lb, eye, upper=False), reps=50),
            "bound": bound(b * blk_bytes, b * 256**3 / 3),
        }
    per_cta_ms = (256**3 / 3) / (FP32_FLOP_PER_S / SMS) * 1e3

    # kernel 4 at the probe's shape: x (N,) → K (N, N), the same 1 GiB write
    x4 = probe.x
    km4_ms = event_ms(lambda: km_se_d1(x4), reps=20)
    km4_plain_ms = event_ms(lambda: km_se_d1_plain(x4), reps=5)
    km4_bound, km4_by = bound((N + N * N) * 4, N * N * 10)

    # kernel 1 at the Mauna Loa path's D = 2 shape: the seasonal term's
    # 12288² same-input SE matrix of the 2-D embedding
    n_d2 = ml_d2.shape[0]
    km_d2 = {"shape": f"same-input {n_d2}x{n_d2} D=2 SE f32",
             "ms": event_ms(lambda: kernelmatrix_forward(ml_d2, None, "se", v1), reps=20),
             "plain_ms": event_ms(lambda: kernelmatrix_plain(ml_d2, None, "se", v1), reps=3),
             "bound_ms": bound((n_d2 * 2 + n_d2 * n_d2) * 4, n_d2 * n_d2 * 13)[0]}

    kernels = [
        {"name": "kernelmatrix", "route": "cuda",
         "source": "stheno_tpu_torch/cuda/csrc/kernelmatrix.cu",
         "replaces": "stheno_tpu/experimental/pallas/kernelmatrix.py:101",
         "launches": step_counts["kernelmatrix"], "max_abs_err": km_err_main,
         "ms": km_ms, "plain_ms": km_plain_ms, "bound_ms": km_bound, "bound_by": km_by,
         "library_ms": None, "shape": f"same-input {N}x{N} D=1 SE f32",
         "launches_mauna_loa_step": ml_counts["kernelmatrix"], "max_abs_err_mauna_loa": km_err_ml,
         "mauna_loa_d2": km_d2},
        {"name": "chol_block", "route": "cuda",
         "source": "stheno_tpu_torch/cuda/csrc/chol_block.cu",
         "replaces": "stheno_tpu/experimental/pallas/chol_block.py:66",
         "launches": step_counts["chol_block"], "max_abs_err": chol_err_main,
         "ms": ch_ms, "plain_ms": ch_plain_ms, "bound_ms": ch_bound, "bound_by": ch_by,
         "library_ms": ch_lib_ms, "library_ex_ms": ch_lib_ex_ms, "shape": "(1, 256, 256) f32",
         "one_cta_bound_ms": per_cta_ms, "launches_mauna_loa_step": ml_counts["chol_block"],
         "design": "32x32 tiles in shared memory, right-looking with a one-column lookahead: "
                   "diagonal tile in one warp, panel solve a row per thread, trailing update "
                   "in 8x4 register micro-tiles; 18 CTA barriers at n=256",
         "previous_design": "a right-looking sweep over single columns, two CTA barriers "
                            "per column (512 at n=256)"},
        {"name": "tri_inv_block", "route": "cuda",
         "source": "stheno_tpu_torch/cuda/csrc/chol_block.cu",
         "replaces": "stheno_tpu/experimental/pallas/chol_block.py:110",
         "launches": step_counts["tri_inv_block"], "max_abs_err": tri_err_main,
         "ms": tri[4]["ms"], "plain_ms": tri[4]["plain_ms"],
         "bound_ms": tri[4]["bound"][0], "bound_by": tri[4]["bound"][1],
         "library_ms": tri[4]["library_ms"], "shape": "(4, 256, 256) f32",
         "device_ms": tri[4]["device_ms"], "one_cta_bound_ms": per_cta_ms,
         "launches_mauna_loa_step": ml_counts["tri_inv_block"],
         "batch1": {"ms": tri[1]["ms"], "device_ms": tri[1]["device_ms"],
                    "plain_ms": tri[1]["plain_ms"], "library_ms": tri[1]["library_ms"],
                    "bound_ms": tri[1]["bound"][0]},
         "design": "32x32 tiles in shared memory, M written over L, 16 warps: every diagonal "
                   "tile inverted at once (a warp each), then right-looking over tile columns with "
                   "register-blocked tile products (8x4 or, in narrow phases, 4x4 micro-tiles "
                   "on half tiles); 16 CTA barriers at n=256",
         "previous_design": "one thread per column of M over its packed triangle, four rows "
                            "a pass, no barrier",
         "launches_by_shape": step_shapes["tri_inv_block"]},
        {"name": "km_se_d1", "route": "cuda",
         "source": "stheno_tpu_torch/cuda/csrc/kernelmatrix.cu",
         "replaces": "scripts/perf_probe.py:128",
         "launches": probe_counts["km_se_d1"], "max_abs_err": km4_err,
         "ms": km4_ms, "plain_ms": km4_plain_ms, "bound_ms": km4_bound, "bound_by": km4_by,
         "library_ms": None, "shape": f"x ({N},) -> K {N}x{N} SE variance 1.5 f32",
         "path": "perf_probe (kernel 1's SE, D=1 instance)",
         "launches_mauna_loa_step": ml_counts["km_se_d1"]},
    ]
    # the step's flops: the blocked forward n³/3 and its reverse sweep 2n³/3
    # (the m×m @ m×B trailing GEMM of each panel); predict: the forward and
    # the two triangular solves of an N×M right-hand side
    step_bound, _ = bound(0, N**3)
    predict_bound, _ = bound(0, N**3 / 3 + 2 * N * N * M)
    emit({"flagship": {"n": N, "m": M, "dtype": "float32", "step_ms": step_ms,
                       "predict_ms": predict_ms, **stages,
                       "step_bound_ms": step_bound, "predict_bound_ms": predict_bound,
                       "peak_step_gib": peak_step_gib, "card": card}})
    emit({"profile_step": profile_ms(lambda: step(theta))})
    emit({"profile_predict": profile_ms(lambda: predict(theta_d, x, y, xp))})

    # ---- 9. the pseudo-point path (BASELINE #2) -------------------------------
    torch.cuda.empty_cache()
    pp_counts, pp_cross = pseudo_point_path(torch, dev, card, step, theta)
    for row in kernels:
        row["launches_pseudo_point_step"] = pp_counts[row["name"]]
    kernels[0]["pseudo_point_cross"] = pp_cross
    kernels[0]["max_abs_err_pseudo_points"] = km_err_pp

    # ---- 10. the samplers' path (BASELINE #5, SMC) ------------------------------
    sampler_counts, smc_counts, batched_row, sampler_runs = samplers_path(torch, dev, card)
    for row in kernels:
        row["launches_samplers"] = sampler_counts[row["name"]]
        row["launches_smc"] = smc_counts[row["name"]]
    batched_row["launches_step"] = step_counts["kernelmatrix_batched"]

    # ---- 11. derivatives, convolutions, the NKN, pathwise samples ------------
    path_counts, jvp_rows = derivatives_path(torch, dev, card)
    for row in kernels + [batched_row]:
        for path, c in path_counts.items():
            row[f"launches_{path}"] = c[row["name"]]
    kernels[0]["max_abs_err_jvp"] = max(
        max(r["first_max_abs_err"], r["nested_max_abs_err"]) for r in jvp_rows)
    kernels.insert(1, batched_row)

    # ---- 12. the distributed tier on a one-rank NCCL group --------------------
    torch.cuda.empty_cache()
    par_counts = parallel_path(torch, dev, card, nuts_ref=sampler_runs["nuts"],
                               smc_ref=sampler_runs["smc_se"])
    for row in kernels:
        for path, c in par_counts.items():
            row[f"launches_parallel_{path}"] = c[row["name"]]

    # ---- 13. the examples, three of them at full width ------------------------
    torch.cuda.empty_cache()
    ex = examples_path(torch, dev, card, ex_inputs)
    kernels[0]["examples"] = ex["rows"]
    kernels[0]["max_abs_err_examples"] = km_err_examples
    for row in kernels:
        for path, c in ex["steps"].items():
            row[f"launches_{path}_full"] = c[row["name"]]
    numerics_policy(torch)
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

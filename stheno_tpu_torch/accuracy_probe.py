"""Accuracy probe of the f32 routes of the gradient-enhanced GP and the
deconvolution against f64 (a developer tool, not a test).

    python -m stheno_tpu_torch.accuracy_probe [--n N] [--seeds S] [--device cuda|cpu]
                                              [--nuts-n M] [--part all|routes|precision|chunks]

Each row is one JSON line on stdout.  For each data seed of
`entry.derivative_data` and `entry.deconvolution_data` (seeds 0 .. S − 1),
each noise variance (the paths' own 0.01, and 1.0 where the covariance is
100× better conditioned) and each route of the f32 factor, it prints the
gradient's error in (v, l, noise), each against its own f64 value, and for
the gradient-enhanced GP at σ² = 0.01 the posterior means' errors in f, f′
and f″ (of max|mean64|, at n/16 points).  The routes:

  port           the blocked factor with kernels 2 and 3
  one_gemm       the same with each left-looking update as one GEMM over
                 all earlier columns (the reference's order, and the port's
                 before it summed the update panel by panel)
  library_bases  the blocked factor with the library's base cases
  cusolver       `chol_backend("torch")`: cuSOLVER's whole-matrix factor

f64 runs on `chol_backend("torch")`.  Also, at seed 0 and σ² = 0.01: the
factor's backward error ‖LLᵀ − K‖_F/‖K‖_F and its time for each route
(`factor` rows), and kernels 2 and 3 against their plain versions and the
library on the 256-blocks the deconvolution step hands them (`base_blocks`
rows: backward error of each factor, ‖L M − I‖_F of each inverse).  The
`summary` line is the largest error over the seeds for each path, noise,
route and component.

The GEMM precisions (`--part precision`; `precision` rows): under each
(`gemm_precision`, `bwd_precision`) pair of 'highest', 'high' and
'default', on the blocked route, the f32 −logpdf and its gradient in θ of
the flagship (its one covariance) and of the gradient-enhanced GP at
σ² = 0.01 (seeds 0 .. S − 1), each against f64 on `chol_backend("torch")`:
the value's error, each gradient component's against its own f64 value,
and, once for each forward precision, the factor's backward error
‖LLᵀ − K‖_F/‖K‖_F.  Then (`nuts_precision` rows) the NUTS log-density's
gradient at M = `--nuts-n` points (default 4096, f32), at 16 positions
θ0 + 0.1·N(0, I) made from a seed, each evaluated on its own on the
blocked route (a vmapped batch takes `torch.linalg`, which the precisions
do not reach) at 'highest' and at 'high', component by component (l,
noise, v) against f64.  The `precision_summary` line gives the largest
of each over the seeds and positions.

The hi·hi chunk of 'high' (`--part chunks`, not in 'all'; `chunks` rows):
the f32 errors that phase 14 of `chip_smoke.py` holds, under 'highest' and
under 'high' with `ops/blocked_cholesky.py:_products` swapped for the same
products with the hi·hi term in inner-dimension chunks of 1024, 256, 128,
64 or none, and at 256 with each lo rounded to TF32 before the products
(`CHUNKS`): the flagship's value and each gradient component; the
gradient-enhanced GP's value and gradient (of the largest component) at
σ² = 0.01 for each seed; at seed 0 its components at σ² = 1 and its
means (n/16 points); the two steps' host times.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

import stheno_tpu_torch as stt
from stheno_tpu_torch import entry
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.config import Precision
from stheno_tpu_torch.cuda import chol_block as cb
from stheno_tpu_torch.cuda.tf32_split import tf32_round_plain, tf32_split
from stheno_tpu_torch.ops import blocked_cholesky as bc
from stheno_tpu_torch.ops.chol import cholesky_psd

ROUTES = ("port", "one_gemm", "library_bases", "cusolver")
NOISES = (0.01, 1.0)
PRECISIONS = ("highest", "high", "default")
#: positions of the NUTS rows and the seed of their jitter
NUTS_CHAINS, NUTS_SEED = 16, 5
#: the `chunks` rows' variants of 'high': (name, hi·hi chunk or None, lo
#: rounded to TF32 before the products)
CHUNKS = (("1024", 1024, False), ("256", 256, False), ("128", 128, False), ("64", 64, False),
          ("none", None, False), ("256_round_lo", 256, True))


def _one_gemm_update(A_panel, L_rows, L_panel, B):
    return A_panel - bc._mm(L_rows, L_panel.T)


@contextlib.contextmanager
def route(name):
    """The scope of one route of the f32 factor (see the module note)."""
    if name == "cusolver":
        with stt.config.chol_backend("torch"):
            yield
        return
    with contextlib.ExitStack() as stack:
        stack.enter_context(stt.config.chol_backend("blocked"))
        if name == "library_bases":
            stack.enter_context(stt.config.scoped(base_cholesky=bc.torch_chol_lower,
                                                  base_tri_inv=bc.torch_tri_inv_lower))
        if name == "one_gemm":
            # the probe's own swap of the update, undone on exit
            kept, bc._left_update = bc._left_update, _one_gemm_update
            stack.callback(setattr, bc, "_left_update", kept)
        yield


def _emit(row):
    print(json.dumps(row), flush=True)


def _worse(prev, e):
    """The larger error, NaN if either is NaN (a factor that broke)."""
    return e if e != e or prev is None or e > prev else prev


def _f64(theta):
    return {k: v.double() for k, v in theta.items()}


def _own_rel(g, g64):
    return {k: abs(g[k].item() - g64[k].item()) / abs(g64[k].item()) for k in g64}


def _mean_rel(ms, ms64, m):
    return {k: ((ms.mean[sl].double() - ms64.mean[sl]).abs().max() / ms64.mean[sl].abs().max()).item()
            for k, sl in zip(("f", "df", "ddf"), torch.arange(3 * m).split(m))}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _with_noise(theta, noise):
    out = dict(theta)
    out["noise"] = torch.tensor(noise, dtype=theta["noise"].dtype, device=theta["noise"].device)
    return out


def _sym64(K):
    """f64 copy of the symmetric matrix whose lower triangle is tril(K)
    (what the blocked factor reads)."""
    K64 = torch.tril(K).double()
    return K64 + torch.tril(K64, -1).mT


def _bwd_err(L, K64):
    """The factor's backward error ‖LLᵀ − K‖_F/‖K‖_F, in f64."""
    L64 = L.double()
    return ((L64 @ L64.mT - K64).norm() / K64.norm()).item()


def _factor_rows(theta, data, dev):
    fx = entry.derivative_observation(theta, data)
    with torch.no_grad():
        K = fx.cov()
        K64 = _sym64(K)
        for name in ROUTES:
            with route(name):
                L = cholesky_psd(K)
                _sync(dev)
                t0 = time.perf_counter()
                cholesky_psd(K)
                _sync(dev)
                ms = (time.perf_counter() - t0) * 1e3
            _emit({"row": "factor", "route": name, "n": K.shape[-1], "bwd_err": _bwd_err(L, K64),
                   "factor_ms": ms})
            del L


def _base_block_rows(theta, data):
    """Kernels 2 and 3 against their plain versions and the library on the
    base blocks (256² at the paths' size) one f32 deconvolution step hands
    them."""
    seen = {"chol": [], "inv": []}

    def keep_chol(A):
        seen["chol"].append(A.detach().reshape(-1, *A.shape[-2:]))
        return cb.chol_block(A)

    def keep_inv(L):
        seen["inv"].append(L.detach().reshape(-1, *L.shape[-2:]))
        return cb.tri_inv_block(L)

    with route("port"), stt.config.scoped(base_cholesky=keep_chol, base_tri_inv=keep_inv):
        entry.deconvolution_step(theta, data)
    base = max(a.shape[-1] for a in seen["chol"])
    A = torch.cat([a for a in seen["chol"] if a.shape[-1] == base])
    Ls = torch.cat([a for a in seen["inv"] if a.shape[-1] == base])
    A64 = torch.tril(A).double()
    A64 = A64 + torch.tril(A64, -1).mT
    for name, fn in (("kernel", cb.chol_block), ("plain", cb.chol_block_plain),
                     ("library", bc.torch_chol_lower)):
        L = torch.tril(fn(A)).double()
        err = (L @ L.mT - A64).norm(dim=(-2, -1)) / A64.norm(dim=(-2, -1))
        _emit({"row": "base_blocks", "op": "chol_block", "route": name, "blocks": A.shape[0],
               "bwd_err_max": err.max().item(), "bwd_err_median": err.median().item()})
    L64 = torch.tril(Ls).double()
    eye = torch.eye(L64.shape[-1], dtype=L64.dtype, device=L64.device)
    for name, fn in (("kernel", cb.tri_inv_block), ("plain", cb.tri_inv_block_plain),
                     ("library", bc.torch_tri_inv_lower)):
        res = (L64 @ torch.tril(fn(Ls)).double() - eye).norm(dim=(-2, -1))
        _emit({"row": "base_blocks", "op": "tri_inv_block", "route": name, "blocks": Ls.shape[0],
               "right_residual_max": res.max().item(), "right_residual_median": res.median().item()})


def run(n=16384, seeds=3, device="cuda"):
    dev = resolve_device(device)
    m = max(16, n // 16)
    worst = {}

    def note(path, noise, name, errs):
        for k, e in errs.items():
            key = f"{path} noise={noise} {name} {k}"
            worst[key] = _worse(worst.get(key), e)

    for seed in range(seeds):
        xf, xd, y, xp, theta = entry.derivative_data(n, m, torch.float32, dev, seed=seed)
        data = (xf, xd, y, xp)
        data64 = tuple(t.double() for t in data)
        for noise in NOISES:
            th = _with_noise(theta, noise)
            with stt.config.chol_backend("torch"):
                _, g64 = entry.derivative_step(_f64(th), data64)
                ms64 = entry.derivative_predict(_f64(th), data64, noise=1e-6) if noise == 0.01 else None
            for name in ROUTES:
                with route(name):
                    row = {"row": "derivative", "seed": seed, "noise": noise, "route": name,
                           "grad_err": _own_rel(entry.derivative_step(th, data)[1], g64)}
                    if ms64 is not None:
                        row["mean_err"] = _mean_rel(entry.derivative_predict(th, data, noise=1e-6),
                                                    ms64, m)
                note("derivative", noise, name, {**row["grad_err"], **row.get("mean_err", {})})
                _emit(row)
            if seed == 0 and noise == 0.01:
                _factor_rows(th, data, dev)
        del data, data64
        cx, cy, _, cth = entry.deconvolution_data(n, m, 2048, torch.float32, dev, seed=seed)
        for noise in NOISES:
            th = _with_noise(cth, noise)
            with stt.config.chol_backend("torch"):
                _, g64 = entry.deconvolution_step(_f64(th), (cx.double(), cy.double()))
            for name in ROUTES:
                with route(name):
                    errs = _own_rel(entry.deconvolution_step(th, (cx, cy))[1], g64)
                note("deconvolution", noise, name, errs)
                _emit({"row": "deconvolution", "seed": seed, "noise": noise, "route": name,
                       "grad_err": errs})
        if seed == 0:
            _base_block_rows(cth, (cx, cy))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    _emit({"row": "summary", "seeds": seeds, "n": n, "max_over_seeds": worst})
    return worst


@contextlib.contextmanager
def precision_pair(gemm, bwd):
    """The blocked route under `gemm_precision(gemm)` and
    `bwd_precision(bwd)`."""
    with stt.config.chol_backend("blocked"), stt.config.gemm_precision(gemm), \
            stt.config.bwd_precision(bwd):
        yield


def _value_grad(fn, theta):
    leaves = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
    val = fn(leaves)
    grads = torch.autograd.grad(val, list(leaves.values()))
    return val.detach(), dict(zip(leaves, grads))


def _pair_rows(path, seed, fn, fn64, theta, cov, note):
    """One `precision` row per (gemm, bwd) pair for the step `fn(θ)`
    against `fn64(θ64)` on `chol_backend("torch")`."""
    with stt.config.chol_backend("torch"):
        v64, g64 = _value_grad(fn64, _f64(theta))
    for gemm in PRECISIONS:
        with torch.no_grad(), precision_pair(gemm, None):
            K = cov()
            bwd_err = _bwd_err(cholesky_psd(K), _sym64(K))
            del K
        for bwd in PRECISIONS:
            with precision_pair(gemm, bwd):
                v, g = _value_grad(fn, theta)
            errs = {"value": abs(v.item() - v64.item()) / abs(v64.item()), **_own_rel(g, g64)}
            note(f"{path} gemm={gemm} bwd={bwd}", errs)
            _emit({"row": "precision", "path": path, "seed": seed, "gemm": gemm, "bwd": bwd,
                   "value_err": errs.pop("value"), "grad_err": errs, "factor_bwd_err": bwd_err})


def _nuts_rows(nuts_n, dev, note):
    """The NUTS log-density's gradient at 'highest' and 'high' against f64,
    position by position (see the module note)."""
    data = entry.nuts_data(nuts_n, torch.float32, dev)
    fn, theta0, _ = entry.nuts_logdensity(data)
    fn64, _, _ = entry.nuts_logdensity(tuple(t.double() for t in data))
    jitter = np.random.default_rng(NUTS_SEED).normal(size=(NUTS_CHAINS, theta0.shape[0]))
    names = ("l", "noise", "v")  # the flat order: sorted keys
    for c in range(NUTS_CHAINS):
        th = theta0 + 0.1 * torch.as_tensor(jitter[c], dtype=theta0.dtype, device=dev)
        with stt.config.chol_backend("torch"):
            _, g64 = _value_grad(lambda t: fn64(t["q"]), {"q": th.double()})
        for prec in PRECISIONS[:2]:
            with precision_pair(prec, None):
                _, g = _value_grad(lambda t: fn(t["q"]), {"q": th})
            errs = {k: abs(a - b) / abs(b) for k, a, b in zip(names, g["q"].tolist(),
                                                               g64["q"].tolist())}
            note(f"nuts n={nuts_n} {prec}", errs)
            _emit({"row": "nuts_precision", "n": nuts_n, "position": c, "precision": prec,
                   "grad_err": errs, "grad_f64": dict(zip(names, g64["q"].tolist()))})


def run_precision(n=16384, seeds=3, device="cuda", nuts_n=4096):
    """The precision rows (module note); returns the largest errors."""
    dev = resolve_device(device)
    worst = {}

    def note(key, errs):
        for k, e in errs.items():
            worst[f"{key} {k}"] = _worse(worst.get(f"{key} {k}"), e)

    x, y, _, theta = entry.flagship_data(n, 1, torch.float32, dev)
    x64, y64 = x.double(), y.double()
    _pair_rows("flagship", None, lambda t: entry.nlml(t, x, y), lambda t: entry.nlml(t, x64, y64),
               theta, lambda: entry.build(theta)(stt.GPPPInput("f3", x), theta["noise"]).cov(), note)
    del x, y, x64, y64
    for seed in range(seeds):
        xf, xd, y, xp, dtheta = entry.derivative_data(n, 16, torch.float32, dev, seed=seed)
        data = (xf, xd, y)
        data64 = tuple(t.double() for t in data)
        _pair_rows("derivative", seed,
                   lambda t: -stt.logpdf(entry.derivative_observation(t, data), y),
                   lambda t: -stt.logpdf(entry.derivative_observation(t, data64), data64[2]),
                   dtheta, lambda: entry.derivative_observation(dtheta, data).cov(), note)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    _nuts_rows(nuts_n, dev, note)
    _emit({"row": "precision_summary", "seeds": seeds, "n": n, "nuts_n": nuts_n,
           "max_over_seeds": worst})
    return worst


@contextlib.contextmanager
def high_products(chunk, round_lo):
    """'high' products as `bc._products` makes them, with the hi·hi term
    in inner-dimension chunks of `chunk` (None: one product) and, with
    `round_lo`, each lo rounded to TF32 on the card too (the CPU always
    rounds it, as `_products` does); the probe's own swap, undone on exit."""
    kept = bc._products

    def products(a, b, prec):
        if prec is not Precision.HIGH:
            return kept(a, b, prec)
        ha, la = tf32_split(a)
        hb, lb = tf32_split(b)
        if round_lo or not a.is_cuda:
            la, lb = tf32_round_plain(la), tf32_round_plain(lb)
        k = a.shape[-1]
        c = chunk or k
        with bc._tf32() if a.is_cuda else contextlib.nullcontext():
            out = ha @ lb
            bc._add_product(out, la, hb)
            for j in range(0, k, c):
                bc._add_product(out, ha[..., j : j + c], hb[..., j : j + c, :])
        return out

    bc._products = products
    try:
        yield
    finally:
        bc._products = kept


def _host_ms(fn, dev, reps=2):
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def run_chunks(n=16384, seeds=3, device="cuda"):
    """The `chunks` rows (module note); returns them."""
    dev = resolve_device(device)
    m = max(16, n // 16)
    x, y, _, theta = entry.flagship_data(n, 1, torch.float32, dev)
    flag = lambda t: entry.nlml(t, x, y)  # noqa: E731
    with stt.config.chol_backend("torch"):
        v64, g64 = _value_grad(lambda t: entry.nlml(t, x.double(), y.double()), _f64(theta))
    paths = []
    for seed in range(seeds):
        xf, xd, yd, xp, dth = entry.derivative_data(n, m, torch.float32, dev, seed=seed)
        data = (xf, xd, yd, xp)
        data64 = tuple(t.double() for t in data)
        with stt.config.chol_backend("torch"):
            ref = entry.derivative_step(_f64(dth), data64)
            low = None
            if seed == 0:
                th1 = _with_noise(dth, 1.0)
                low = (th1, entry.derivative_step(_f64(th1), data64)[1],
                       entry.derivative_predict(_f64(dth), data64, noise=1e-6))
        paths.append((dth, data, ref, low))
    rows = []
    for name, chunk, round_lo in (("highest", None, False),) + CHUNKS:
        with contextlib.ExitStack() as stack:
            stack.enter_context(precision_pair("highest" if name == "highest" else "high", None))
            if name != "highest":
                stack.enter_context(high_products(chunk, round_lo))
            v, g = _value_grad(flag, theta)
            row = {"row": "chunks", "variant": name, "n": n,
                   "flagship_value_err": abs(v.item() - v64.item()) / abs(v64.item()),
                   "flagship_grad_err": _own_rel(g, g64),
                   "flagship_step_ms": _host_ms(lambda: _value_grad(flag, theta), dev)}
            for seed, (dth, data, (dv64, dg64), low) in enumerate(paths):
                dv, dg = entry.derivative_step(dth, data)
                gmax = max(abs(t.item()) for t in dg64.values())
                row[f"derivative_seed{seed}"] = {
                    "value_err": abs(dv.item() - dv64.item()) / abs(dv64.item()),
                    "grad_err_of_largest": max(abs(dg[k].item() - dg64[k].item()) for k in dg64) / gmax}
                if low is not None:
                    th1, g1_64, ms64 = low
                    row["derivative_components_at_noise_1"] = _own_rel(
                        entry.derivative_step(th1, data)[1], g1_64)
                    row["derivative_mean_err"] = _mean_rel(
                        entry.derivative_predict(dth, data, noise=1e-6), ms64, m)
                    row["derivative_step_ms"] = _host_ms(lambda: entry.derivative_step(dth, data), dev)
        _emit(row)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m stheno_tpu_torch.accuracy_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16384, help="observations of each path (default 16384)")
    ap.add_argument("--seeds", type=int, default=3, help="data seeds 0 .. S − 1 (default 3)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--nuts-n", type=int, default=4096, help="N of the NUTS rows (default 4096)")
    ap.add_argument("--part", default="all", choices=("all", "routes", "precision", "chunks"),
                    help="the routes' rows, the precision rows, both (default), or the chunk rows")
    args = ap.parse_args(argv)
    if args.part in ("all", "routes"):
        run(args.n, args.seeds, args.device)
    if args.part in ("all", "precision"):
        run_precision(args.n, args.seeds, args.device, args.nuts_n)
    if args.part == "chunks":
        run_chunks(args.n, args.seeds, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

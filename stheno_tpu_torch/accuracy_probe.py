"""Accuracy probe of the f32 routes of the gradient-enhanced GP and the
deconvolution against f64 (a developer tool, not a test).

    python -m stheno_tpu_torch.accuracy_probe [--n N] [--seeds S] [--device cuda|cpu]

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
last line is the largest error over the seeds for each path, noise, route
and component (`summary`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

import stheno_tpu_torch as stt
from stheno_tpu_torch import entry
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.cuda import chol_block as cb
from stheno_tpu_torch.ops import blocked_cholesky as bc
from stheno_tpu_torch.ops.chol import cholesky_psd

ROUTES = ("port", "one_gemm", "library_bases", "cusolver")
NOISES = (0.01, 1.0)


def _one_gemm_update(A_panel, L_rows, L_panel, B):
    return A_panel - L_rows @ L_panel.T


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


def _factor_rows(theta, data, dev):
    fx = entry.derivative_observation(theta, data)
    with torch.no_grad():
        K = fx.cov()
        K64 = torch.tril(K).double()
        K64 = K64 + torch.tril(K64, -1).mT
        for name in ROUTES:
            with route(name):
                L = cholesky_psd(K)
                _sync(dev)
                t0 = time.perf_counter()
                cholesky_psd(K)
                _sync(dev)
                ms = (time.perf_counter() - t0) * 1e3
            L64 = L.double()
            err = ((L64 @ L64.mT - K64).norm() / K64.norm()).item()
            _emit({"row": "factor", "route": name, "n": K.shape[-1], "bwd_err": err, "factor_ms": ms})
            del L, L64


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
            worst[key] = max(worst.get(key, 0.0), e)

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


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m stheno_tpu_torch.accuracy_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16384, help="observations of each path (default 16384)")
    ap.add_argument("--seeds", type=int, default=3, help="data seeds 0 .. S − 1 (default 3)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.n, args.seeds, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

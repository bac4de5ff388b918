"""Performance probe of the port's N = 16384 hot-loop components
(counterpart of `scripts/perf_probe.py`; a developer tool, not a test).

    python -m stheno_tpu_torch.perf_probe [variant ...] [--n N] [--reps R]
                                          [--device cuda|cpu] [--markov-n M]

Method, as in the reference (`scripts/perf_probe.py:1-61`): every timed call
ends in a host pull (`float()`) of a scalar that consumes the whole output;
inputs vary per call (`x + i·1e-7`); one untimed first call, then `reps`
timed ones, of which the median is reported.  For a Cholesky factor the
scalar is ΣL² = tr(L Lᵀ), which equals tr(K) = N·1.6 for a correct factor:
a forcing scalar, a NaN detector and a correctness check at once.  Each
variant prints a JSON line on stdout (its median, first-call time, scalar
and checks) and a line on stderr; a sorted summary follows.  A failed check
makes the probe exit with code 1.

Variants (names as in the reference; default: all).  A name in CAPS below
is a group that runs several rows.

  null                  fixed host-pull overhead
  chol_lax              torch.linalg.cholesky (the library baseline)
  chol_cur, chol_b1024, chol_b4096, chol_f{block}_b{base}
                        the blocked forward at the port's default GEMM
                        precision, 'highest' (full fp32; the reference ran
                        its base ladder at HIGH, three-pass bf16)
  chol_high             chol_cur under `gemm_precision('high')` (3xTF32)
  chol_grad, chol_grad_* (rec/iter/fused, bases, blocks, via_inv)
                        forward + backward of ΣL²; the gradient is I
  chol_grad_bp_def, chol_grad_bp_high
                        the iter backward at panels of 4096 under
                        `bwd_precision('default')` (one TF32 pass: its
                        distance from I is printed, not held) and
                        `bwd_precision('high')`, the forward at 'highest'
  chol_impl_plain, chol_impl_sym, chol_psd_path
                        the forward without and with the `sym` fold, and
                        `cholesky_psd`
  chol_btri, chol_pal_base, chol_pal_all
                        library base factoriser and inverse; kernel 2 with
                        the library inverse; kernels 2 and 3 ("pal" keeps
                        the reference's meaning: the hand-written kernels)
  chol_high_btri        chol_btri under `gemm_precision('high')`
  BASE_CHAIN            base_chain_lax, base_chain_pal: 64 serially
                        dependent 256-block factorisations
  TRSM                  trsm_lax, trsm_blocked and their _grad rows
  SUBST_WIDTH           subst_trsm_w{k}, subst_inv_w{k}: the blocked forward
                        substitution at block 1024 of k = 1 to 512
                        right-hand sides, its diagonal blocks by TRSM
                        against GEMMs on their inverses' stack, built in
                        the call (the source of `_INV_MIN_COLS`)
  logpdf_fwd, bench_kgrad, bench_hgrad
                        the flagship decomposed, K built by broadcast
  accuracy              N = 4096 logpdf and gradient, f32 against f64
  GEMM_PEAK             fp32 at 8k and 16k, TF32 and bf16 at 8k
                        (calibration only: the rest of the port is fp32)
  FWD_FLOOR             fwd_now, gemm_shapes, diag_chain, diag_chain_lax
                        and the residual arithmetic
  MARKOV_1M             markov_fwd_{M}, markov_grad_{M} (M = --markov-n)
  DIST_P1               logpdf_single, logpdf_dist_p1, chol_dist_p1: the
                        distributed factorisation and logpdf on a one-rank
                        'rows' mesh against the single-card route
  RING_P1               ring_p1_fwd, ring_p1_ygrad: the matrix-free ring's
                        logpdf and y-gradient on a one-rank mesh against
                        the dense logpdf and −K̂⁻¹y
  km_xla, km_pal        the broadcast SE matrix, and kernel 4 (`km_se_d1`,
                        kernel 1's SE, D = 1 instance)

Group selectors are the lower-case names: base_chain, trsm, subst_width,
gemm_peak, fwd_floor, dist_p1, ring_p1, markov_1m.  Rows that the reference runs at
its library default precision (HIGH) run at the port's default
('highest'), so no row changes what it measured before the precision
rows came; those four rows scope their precision themselves.  The
distributed rows make a one-rank group (NCCL on the card, gloo on the
CPU) when the process has none, and destroy it when the run ends.

The Cholesky probes build K with kernel 4 (one write, as XLA's fused
broadcast is in the reference) and add the noise into its diagonal in
place.  Base blocks that do not fit kernels 2 and 3 (their working sets
live in shared memory: `cuda/chol_block.py:fits`, today n ≤ 288) run on the
library base cases, as the ladder's rows with base 512 or 1024 do, and say
so.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import numpy as np
import torch

from stheno_tpu_torch import config as _cfg
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.cuda.chol_block import chol_block, fits
from stheno_tpu_torch.cuda.kernelmatrix import km_se_d1, km_se_d1_plain
from stheno_tpu_torch.kernels import Matern32Kernel, with_lengthscale
from stheno_tpu_torch.markov import markov_gp_logpdf
from stheno_tpu_torch.ops import blocked_cholesky as bc
from stheno_tpu_torch.ops import chol as C

F32 = torch.float32
#: ΣL² of an f32 factor equals tr(K) to rounding (the TPU build measured
#: 8e-6 at N = 16384, `scripts/perf_probe.py` docstring era)
CHOL_RTOL = 1e-4
#: max |∂ΣL²/∂K − I| of an f32 gradient at N = 16384 (K's condition number
#: is about 6e4), measured on an H100: ≤ 6.3e-4 for every iter and rec row,
#: and for the fused sweep, which applies explicit panel inverses whose f32
#: error grows with the panel width, 3.3e-4, 1.1e-3 and 1.4e-3 at panels of
#: 512, 1024 and 2048 ...
GRAD_ATOL = 5e-3
#: ... and 3.2e-2 at 4096, its own limit (`grad_atol`)
WIDE_FUSED_GRAD_ATOL = 5e-2
#: the N = 4096 accuracy row, f32 against f64: value (measured 2.2e-6 on an
#: H100) and the largest relative error of the three gradient components
#: (measured 7.2e-3; the f32 library route is printed beside it)
ACC_VAL_RTOL, ACC_GRAD_RTOL = 1e-4, 2e-2
#: ring_p1: the reference probe's settings (`scripts/perf_probe.py:720-723`)
#: and the limit of the y-gradient's error against the dense f64 −K̂⁻¹y,
#: max|g + α| / max|α| (this probe and `chip_smoke.py` phase 12).  The f32
#: CG's solution differs from the f64 solve by its f32 matvecs' rounding
#: times K̂⁻¹: about u·κ with u = 6e-8 and κ ≤ λmax ≈ 6.2e3 (λmin ≥ 1 from
#: the unit noise) at N = 16384, i.e. 3.7e-4; its stopping residual, 1e-6·‖y‖,
#: adds at most 1e-6·κ, and an H100 read 2.5e-4
RING_P1 = dict(num_probes=8, lanczos_iters=20, tol=1e-6, maxiter=400)
RING_YGRAD_RTOL = 1e-3
#: H100 SXM fp32 rate outside the tensor cores (NVIDIA data sheet)
FP32_SPEC_FLOP_PER_S = 67e12

#: grad ladder (reference `scripts/perf_probe.py:240-263`): name, forward
#: block, backward base, via_inv, mode, backward block
GRAD_LADDER = [
    ("chol_grad_rec", 1024, 256, True, "rec", 1024),
    ("chol_gradb512", 1024, 512, True, "rec", 1024),
    ("chol_gradb1024", 1024, 1024, True, "rec", 1024),
    ("chol_grad_noinv", 1024, 256, False, "rec", 1024),
    ("chol_grad_iter1024", 1024, 256, True, "iter", 1024),
    ("chol_grad_iter2048", 1024, 256, True, "iter", 2048),
    ("chol_grad_iter512", 1024, 256, True, "iter", 512),
    ("chol_grad_iter4096", 1024, 256, True, "iter", 4096),
    ("chol_grad_iter8192", 1024, 256, True, "iter", 8192),
    ("chol_grad_i4096_bb512", 1024, 512, True, "iter", 4096),
    ("chol_grad_i4096_bb1024", 1024, 1024, True, "iter", 4096),
    ("chol_grad_i4096_noinv", 1024, 256, False, "iter", 4096),
    ("chol_grad_i2048_f2048", 2048, 256, True, "iter", 2048),
    ("chol_grad_fused512", 1024, 256, True, "fused", 512),
    ("chol_grad_fused1024", 1024, 256, True, "fused", 1024),
    ("chol_grad_fused2048", 1024, 256, True, "fused", 2048),
    ("chol_grad_fused4096", 1024, 256, True, "fused", 4096),
    ("chol_grad_f1024_bb512", 1024, 512, True, "fused", 1024),
]
#: right-hand side widths of the `subst_width` rows
SUBST_WIDTHS = (1, 2, 4, 8, 16, 32, 128, 512)
#: forward base ladder (reference `:303`): block, base
FWD_LADDER = [(1024, 256), (1024, 512), (1024, 1024), (2048, 512), (2048, 1024)]


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _flat_dot(a, b=None):
    """Σ a⊙b as one dot product (no N² temporary)."""
    a = a.reshape(-1)
    return a @ (a if b is None else b.reshape(-1))


#: scoped overrides that swap in the library base cases
LIBRARY_BASE = dict(base_cholesky=bc.torch_chol_lower, base_tri_inv=bc.torch_tri_inv_lower)


def base_scope(base):
    """The base-case overrides of a forward with this base: none (kernels 2
    and 3) where the kernels take it, else the library versions."""
    return {} if fits(base) else LIBRARY_BASE


def identity_distance(g):
    """max |g − I| without an N² temporary (g is restored)."""
    d = g.diagonal().clone()
    g.diagonal().zero_()
    off = g.abs().max()
    g.diagonal().copy_(d)
    return max(off.item(), (d - 1.0).abs().max().item())


def grad_atol(bwd=None):
    """The limit on max |∂ΣL²/∂K − I| under `bwd_params(**bwd)`: the fused
    sweep at panels over 2048 has its own."""
    bwd = bwd or {}
    wide = bwd.get("mode") == "fused" and bwd.get("block", bc._BWD_BLOCK) > 2048
    return WIDE_FUSED_GRAD_ATOL if wide else GRAD_ATOL


def grad_of_sum_sq(K, block=1024, base=256, bwd=None, bwd_prec=None):
    """(ΣL², ∂ΣL²/∂K) of L = blocked_cholesky(K) under `bwd_params(**bwd)`
    and `bwd_precision(bwd_prec)`; the gradient is I for a correct reverse
    rule."""
    K = K.detach().requires_grad_(True)
    with _cfg.bwd_params(**(bwd or {})), _cfg.bwd_precision(bwd_prec):
        L = bc.blocked_cholesky(K, block, base)
    v = _flat_dot(L)
    (g,) = torch.autograd.grad(v, K)
    return v.detach(), g


def markov_inputs(nm, dtype=F32, device="cuda"):
    """The reference probe's state-space data (`scripts/perf_probe.py:765-769`):
    seed 0, x sorted uniform on [0, 4000], y = sin(0.3x) + 0.3·noise."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 4000.0, nm))
    y = np.sin(0.3 * x) + 0.3 * rng.standard_normal(nm)
    dev = resolve_device(device)
    return (torch.as_tensor(x, dtype=dtype, device=dev), torch.as_tensor(y, dtype=dtype, device=dev))


def markov_kernel(lv):
    """lv[0]·Matern32(·/lv[1]), the reference probe's state-space kernel."""
    return lv[0] * with_lengthscale(Matern32Kernel(), lv[1])


class Probe:
    """One probe run: the inputs, the timer and the collected rows."""

    def __init__(self, n=16384, reps=4, device="cuda", markov_n=1_000_000):
        self.dev = resolve_device(device)
        self.n, self.reps, self.markov_n = n, reps, markov_n
        self.x = torch.linspace(-5.0, 5.0, n, dtype=F32, device=self.dev)
        self.trK = n * (1.5 + 0.1)
        self.results: dict[str, dict] = {}
        self.failures: list[str] = []
        self._own_group = False

    # ---- method ------------------------------------------------------------
    def km(self, i, noise=0.1):
        """K = 1.5·SE(x + i·1e-7) + noise·I, built by kernel 4."""
        K = km_se_d1(self.x + i * 1e-7)
        K.diagonal().add_(noise)
        return K

    def timed(self, name, fn, expect=None, rtol=CHOL_RTOL, extra=None, flops=None):
        """Run `fn(0)` untimed, then `fn(1..reps)` timed; each returns a
        0-d tensor pulled to the host.  `expect` checks the first scalar;
        `extra` is read after the run for more fields ({"ok": ...} fails
        the row when false); `flops` adds the achieved rate."""
        t0 = time.perf_counter()
        v = float(fn(0))
        first_s = time.perf_counter() - t0
        times = []
        for i in range(1, self.reps + 1):
            t0 = time.perf_counter()
            last = float(fn(i))
            times.append((time.perf_counter() - t0) * 1e3)
        row = {"variant": name, "median_ms": statistics.median(times), "ms": times,
               "first_s": first_s, "scalar": v, "last_scalar": last}
        if flops is not None:
            row["tflops"] = flops / (row["median_ms"] / 1e3) / 1e12
        ok = math.isfinite(v) and math.isfinite(last)
        if expect is not None:
            rel = abs(v - expect) / abs(expect)
            row.update(expect=expect, rel_err=rel, rtol=rtol)
            ok = ok and rel <= rtol
        if extra:
            row.update(extra)
            ok = ok and extra.get("ok", True)
        return self._record(row, ok)

    def _record(self, row, ok):
        row["ok"] = bool(ok)
        row["device"] = str(self.dev)
        self.results[row["variant"]] = row
        if not ok:
            self.failures.append(row["variant"])
        print(json.dumps(row), flush=True)
        ms = row.get("median_ms")
        _log(f"{row['variant']:24s} " + (f"{ms:10.3f} ms" if ms is not None else " " * 13)
             + f"  scalar={row.get('scalar', float('nan')):.6g}" + ("" if ok else "  CHECK FAILED"))
        return row

    # ---- Cholesky rows -----------------------------------------------------
    def chol_row(self, name, chol_fn, scope=None, extra=None):
        """A forward row; `scope` holds raw config overrides for its calls."""

        def run(i):
            with torch.no_grad(), _cfg.scoped(**(scope or {})):
                L = chol_fn(self.km(i))
            return _flat_dot(L)

        return self.timed(name, run, expect=self.trK, extra=extra)

    def grad_row(self, name, block, bwd=None, bwd_prec=None, hold=True):
        """A forward + backward row; with `hold` False the gradient's
        distance from I is printed and not held to a limit."""
        atol = grad_atol(bwd) if hold else None
        seen = {"grad_atol": atol}

        def run(i):
            v, g = grad_of_sum_sq(self.km(i), block, 256, bwd, bwd_prec)
            if i == 0:
                err = identity_distance(g)
                seen.update(grad_max_abs_err_vs_I=err, ok=not hold or err <= atol)
            return v + _flat_dot(g) * 1e-12

        return self.timed(name, run, expect=self.trK, extra=seen)

    # ---- the variants, by name ---------------------------------------------
    def v_null(self):
        self.timed("null", lambda i: torch.sum(self.x[:8]) + i * 1e-7)

    def v_chol_lax(self):
        self.chol_row("chol_lax", torch.linalg.cholesky)

    def v_chol_cur(self):
        self.chol_row("chol_cur", lambda K: bc._blocked_cholesky_impl(K, 2048, 256))

    def v_chol_high(self):
        self.chol_row("chol_high", lambda K: bc._blocked_cholesky_impl(K, 2048, 256),
                      {"gemm_precision": _cfg.Precision.HIGH})

    def v_chol_grad_bp(self, name, prec):
        # the reference's `make_grad_probe(1024, 256, True, "iter", 4096,
        # bwd_prec=...)`; 'default' is a reading (module note)
        self.grad_row(name, 1024, dict(base=256, via_inv=True, mode="iter", block=4096),
                      bwd_prec=prec, hold=prec != "default")

    def v_chol_blocks(self, block):
        self.chol_row(f"chol_b{block}", lambda K: bc._blocked_cholesky_impl(K, block, 256))

    def v_chol_fwd_ladder(self, block, base):
        cases = "kernels 2 and 3" if fits(base) else "library (too large for kernels 2 and 3)"
        self.chol_row(f"chol_f{block}_b{base}", lambda K: bc._blocked_cholesky_impl(K, block, base),
                      base_scope(base), extra={"base_cases": cases})

    def v_chol_grad(self):
        # the library defaults: forward (2048, 256), backward iter at 4096
        self.grad_row("chol_grad", 2048)

    def v_grad_ladder(self, name, block, bwd_base, via_inv, mode, bwd_block):
        self.grad_row(name, block, dict(base=bwd_base, via_inv=via_inv, mode=mode, block=bwd_block))

    def v_chol_impl_plain(self):
        self.chol_row("chol_impl_plain", lambda K: bc._blocked_cholesky_impl(K, 1024, 256))

    def v_chol_impl_sym(self):
        self.chol_row("chol_impl_sym", lambda K: bc._blocked_cholesky_impl(K, 1024, 256, sym=True))

    def v_chol_psd_path(self):
        self.chol_row("chol_psd_path", C.cholesky_psd)

    def _chol_2048(self, name, **scope):
        # the reference's `blocked_chol_btri` (:76-102) is the library
        # forward at (2048, 256) with its base cases swapped
        self.chol_row(name, lambda K: bc._blocked_cholesky_impl(K, 2048, 256), scope)

    def v_chol_btri(self):
        self._chol_2048("chol_btri", **LIBRARY_BASE)

    def v_chol_high_btri(self):
        self._chol_2048("chol_high_btri", **LIBRARY_BASE, gemm_precision=_cfg.Precision.HIGH)

    def v_chol_pal_base(self):
        self._chol_2048("chol_pal_base", base_cholesky=chol_block, base_tri_inv=bc.torch_tri_inv_lower)

    def v_chol_pal_all(self):
        self._chol_2048("chol_pal_all")

    def v_base_chain(self):
        """Critical-path latency of 64 serially dependent 256-block
        factorisations, library against kernel 2, no large GEMMs."""
        b = min(256, self.n)
        A0 = km_se_d1(self.x[:b])
        eye = torch.eye(b, dtype=F32, device=self.dev)
        expect = 64 * (torch.trace(A0).item() + b * 256.0)

        def chain(fn):
            def run(i):
                A = A0 + (256.0 + i * 1e-5) * eye
                acc = torch.zeros((), dtype=F32, device=self.dev)
                for _ in range(64):
                    L = fn(A + acc * 1e-12)  # serial dependence
                    acc = acc + _flat_dot(L)
                return acc

            return run

        for name, fn in (("base_chain_lax", torch.linalg.cholesky), ("base_chain_pal", chol_block)):
            self.timed(name, chain(fn), expect=expect, extra={"chain_length": 64})

    def v_trsm(self):
        """Single-right-hand-side triangular solves at N, library against
        the blocked substitution, and their gradients in L."""
        with torch.no_grad():
            L = bc._blocked_cholesky_impl(self.km(0), 1024, 256)
        y = torch.sin(self.x)
        solvers = {
            "lax": lambda L_, b: torch.linalg.solve_triangular(L_, b[:, None], upper=False)[:, 0],
            "blocked": lambda L_, b: bc.blocked_solve_lower(L_, b, block=1024),
        }
        for key, solve in solvers.items():
            def run(i, solve=solve):
                with torch.no_grad():
                    a = solve(L, y + i * 1e-7)
                return _flat_dot(a)

            self.timed(f"trsm_{key}", run)
        for key, solve in solvers.items():
            def run_grad(i, solve=solve):
                Lg = L.detach().requires_grad_(True)
                a = solve(Lg, y + i * 1e-7)
                v = _flat_dot(a)
                (g,) = torch.autograd.grad(v, Lg)
                return v.detach() + _flat_dot(g) * 1e-12

            self.timed(f"trsm_{key}_grad", run_grad)
        rel = abs(self.results["trsm_lax"]["scalar"] - self.results["trsm_blocked"]["scalar"]) / abs(
            self.results["trsm_lax"]["scalar"])
        _log(f"trsm: lax and blocked scalars differ by {rel:.3g} relative")

    def v_subst_width(self):
        """The blocked forward substitution L x = b at N, block 1024, for b
        of each width in SUBST_WIDTHS: its diagonal blocks by TRSM, then as
        GEMMs against the stack of their inverses, the stack built inside
        the timed call; max |x_stack − x_trsm| / max |x_trsm| held within
        CHOL_RTOL."""
        block = min(1024, self.n)
        with torch.no_grad():
            L = bc._blocked_cholesky_impl(self.km(0), 1024, 256)
        gen = torch.Generator(device=self.dev).manual_seed(0)
        for k in SUBST_WIDTHS:
            b = torch.randn(self.n, k, generator=gen, dtype=F32, device=self.dev)

            def trsm(i, b=b):
                with torch.no_grad():
                    return _flat_dot(bc.blocked_solve(L, b, block=block, via_inv=False)[0])

            def inv(i, b=b):
                with torch.no_grad():
                    return _flat_dot(bc.blocked_solve(L, b, block=block, via_inv=True)[0])

            self.timed(f"subst_trsm_w{k}", trsm)
            with torch.no_grad():
                x = bc.blocked_solve(L, b, block=block, via_inv=False)[0]
                d = bc.blocked_solve(L, b, block=block, via_inv=True)[0] - x
                rel = float(d.abs().max() / x.abs().max())
            self.timed(f"subst_inv_w{k}", inv, extra={"rel_diff_vs_trsm": rel, "ok": rel <= CHOL_RTOL})

    # the flagship, decomposed (reference :424-479)
    def _assemble(self, x, v1, l1, l2, noise):
        d = x[:, None] - x[None, :]
        K = v1 * torch.exp(-0.5 * (d / l1) ** 2)
        d3 = math.sqrt(3.0) * torch.abs(d) / l2
        K = K + (1.0 + d3) * torch.exp(-d3)
        return K + noise * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)

    def _logpdf_of(self, K):
        y = torch.sin(self.x) + 0.2 * torch.cos(7 * self.x)
        return C.mvn_logpdf_chol(y, torch.zeros_like(y), C.cholesky_psd(K))

    def v_logpdf_fwd(self):
        def run(i):
            with torch.no_grad():
                return self._logpdf_of(self._assemble(self.x + i * 1e-7, 1.5, 1.0, 0.5, 0.1))

        self.timed("logpdf_fwd", run)

    def v_bench_kgrad(self):
        def run(i):
            with torch.no_grad():
                K = self._assemble(self.x + i * 1e-7, 1.5, 1.0, 0.5, 0.1)
            K.requires_grad_(True)
            v = self._logpdf_of(K)
            (g,) = torch.autograd.grad(v, K)
            return v.detach() + _flat_dot(g) * 1e-12

        self.timed("bench_kgrad", run)

    def v_bench_hgrad(self):
        def run(i):
            th = [torch.tensor(t, dtype=F32, device=self.dev, requires_grad=True)
                  for t in (1.5, 1.0, 0.5, 0.1)]
            v = self._logpdf_of(self._assemble(self.x + i * 1e-7, *th))
            g = torch.autograd.grad(v, th)
            return v.detach() + g[1] * 1e-9

        self.timed("bench_hgrad", run)

    def v_accuracy(self):
        """f32 logpdf and gradient at N = 4096 against f64, both on this
        device; the f64 side takes `torch.linalg` (kernels 2 and 3 are f32
        only), the f32 side the port's routing."""
        na = min(4096, self.n)

        def lp(dtype):
            xa = torch.linspace(-5.0, 5.0, na, dtype=torch.float64, device=self.dev)
            ya = (torch.sin(xa) + 0.2 * torch.cos(7 * xa)).to(dtype)
            th = [torch.tensor(t, dtype=dtype, device=self.dev, requires_grad=True) for t in (1.5, 1.0, 0.1)]
            x = xa.to(dtype)
            d = (x[:, None] - x[None, :]) / th[1]
            K = th[0] * torch.exp(-0.5 * d * d) + th[2] * torch.eye(na, dtype=dtype, device=self.dev)
            v = C.mvn_logpdf_chol(ya, torch.zeros_like(ya), C.cholesky_psd(K))
            return v.item(), [g.item() for g in torch.autograd.grad(v, th)]

        with _cfg.chol_backend("torch"):
            v64, g64 = lp(torch.float64)
            v32_lib, g32_lib = lp(F32)
        v32, g32 = lp(F32)
        verr = abs(v32 - v64)
        grel = lambda g: max(abs(a - b) / (abs(b) + 1e-12) for a, b in zip(g, g64))
        row = {"variant": "accuracy", "n": na, "logpdf_f32": v32, "logpdf_f64": v64,
               "logpdf_abs_err": verr, "logpdf_rel_err": verr / abs(v64), "grad_max_rel_err": grel(g32),
               "grad_f32": g32, "grad_f64": g64, "rtol": ACC_VAL_RTOL, "grad_rtol": ACC_GRAD_RTOL,
               "library_f32_logpdf_rel_err": abs(v32_lib - v64) / abs(v64),
               "library_f32_grad_max_rel_err": grel(g32_lib), "scalar": v32}
        grel = row["grad_max_rel_err"]
        self._record(row, verr / abs(v64) <= ACC_VAL_RTOL and grel <= ACC_GRAD_RTOL)

    def v_gemm_peak(self):
        """Achieved rate of one plain square GEMM: fp32 (what the port runs)
        at 8k and 16k; TF32 and bf16 at 8k as calibration only.  TF32 is
        switched on for its own GEMMs alone and restored in `finally`."""
        for name, n, kind in (("gemm_fp32_8k", 8192, "fp32"), ("gemm_fp32_16k", 16384, "fp32"),
                              ("gemm_tf32_8k", 8192, "tf32"), ("gemm_bf16_8k", 8192, "bf16")):
            r = torch.arange(n, dtype=F32, device=self.dev)[:, None]
            c = torch.arange(n, dtype=F32, device=self.dev)[None, :]
            a = torch.sin(r * 0.001 + c * 0.002)
            b = torch.cos(r * 0.002 - c * 0.001)
            if kind == "bf16":
                a, b = a.bfloat16(), b.bfloat16()
            run = lambda i, a=a, b=b: torch.sum(a @ b, dtype=F32)
            prev = torch.backends.cuda.matmul.allow_tf32
            try:
                torch.backends.cuda.matmul.allow_tf32 = kind == "tf32"
                row = self.timed(name, run, flops=2 * n**3)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
            _log(f"{name:24s} {row['tflops']:8.2f} TFLOP/s")
            del a, b, r, c

    def v_fwd_floor(self):
        """The blocked forward split into its GEMM shapes, its serial
        diagonal chain and the remainder (reference :548-654)."""
        n = self.n
        B = min(1024, n // 2)
        nb = n // B
        # (i) the forward's GEMM shapes, replayed on slices of two made-once
        # N×N operands: (n−c, c) @ (c, B) updates and (n−c−B, B) @ (B, B) TRSMs
        r = torch.arange(n, dtype=F32, device=self.dev)[:, None]
        c_ = torch.arange(n, dtype=F32, device=self.dev)[None, :]
        Ga = torch.sin(r * 0.001 + c_ * 0.002)
        Gb = torch.sin(r * 0.001 + c_ * 0.002 + 0.5)
        del r, c_
        flops = 0
        for kb in range(nb):
            c0 = kb * B
            flops += 2 * (n - c0) * c0 * B + (2 * (n - c0 - B) * B * B if n - c0 > B else 0)

        def gemm_shapes(i):
            acc = torch.zeros((), dtype=F32, device=self.dev)
            for kb in range(nb):
                c0 = kb * B
                if kb > 0:
                    acc = acc + _flat_dot(Ga[: n - c0, :c0] @ Gb[:B, :c0].T) * 1e-12
                if n - c0 > B:
                    acc = acc + _flat_dot(Ga[: n - c0 - B, :B] @ Gb[:B, :B]) * 1e-12
            return acc

        # (ii) the serial diagonal chain: nb dependent B-block factorisations
        # with their blocked inverses, without the N-tall GEMMs
        K1 = km_se_d1(self.x[:B])
        K1.diagonal().add_(0.1)
        eye = torch.eye(B, dtype=F32, device=self.dev)

        def chain(factor):
            def run(i):
                A, acc = K1, torch.zeros((), dtype=F32, device=self.dev)
                for _ in range(nb):
                    L = factor(A)
                    Mi = bc.blocked_tri_inv_lower(L, base=256)
                    s = _flat_dot(L) + _flat_dot(Mi) * 1e-9
                    A = K1 + (i * 1e-7 + s * 1e-20) * eye
                    acc = acc + s
                return acc

            return run

        def fwd_now(i):
            with torch.no_grad():
                return _flat_dot(bc.blocked_cholesky(self.km(i), B, 256))

        with torch.no_grad():
            self.timed("fwd_now", fwd_now, expect=self.trK)
            self.timed("gemm_shapes", gemm_shapes)
            self.timed("diag_chain", chain(lambda A: bc._blocked_cholesky_impl(A, max(256, B // 4), 256)))
            self.timed("diag_chain_lax", chain(torch.linalg.cholesky))
        med = {k: self.results[k]["median_ms"] for k in ("fwd_now", "gemm_shapes", "diag_chain")}
        residual = med["fwd_now"] - med["gemm_shapes"] - med["diag_chain"]
        spec_ms = flops / FP32_SPEC_FLOP_PER_S * 1e3
        row = {"variant": "fwd_floor", "block": B, "gemm_shapes_flops": flops,
               "gemm_shapes_bound_ms_at_spec": spec_ms,
               "gemm_shapes_tflops": flops / (med["gemm_shapes"] / 1e3) / 1e12,
               "residual_ms": residual, "scalar": residual}
        if "gemm_fp32_16k" in self.results:
            rate = self.results["gemm_fp32_16k"]["tflops"] * 1e12
            row["gemm_shapes_bound_ms_at_gemm_peak"] = flops / rate * 1e3
        _log(f"fwd_floor: GEMM-shape flops {flops:.4g} -> {spec_ms:.2f} ms at 67 TFLOP/s; "
             f"fwd − shapes − chain = {residual:.2f} ms")
        self._record(row, math.isfinite(residual))
        del Ga, Gb

    def v_markov_1m(self):
        """The state-space tier at N = markov_n on the reference's data
        (`scripts/perf_probe.py:753-789`): seed 0, sorted uniform on
        [0, 4000], Matern32 with (variance, lengthscale) = (1.2, 5.0),
        noise 0.1, f32."""
        nm = self.markov_n
        xm, ym = markov_inputs(nm, F32, self.dev)
        lv0 = torch.tensor([1.2, 5.0], dtype=F32, device=self.dev)

        def lp(lv):
            return markov_gp_logpdf(markov_kernel(lv), xm, ym, 0.1, dtype=F32)

        def mk_fwd(i):
            with torch.no_grad():
                return lp(lv0 + i * 1e-7)

        def mk_grad(i):
            lv = (lv0 + i * 1e-7).requires_grad_(True)
            v = lp(lv)
            (g,) = torch.autograd.grad(v, lv)
            return v.detach() + g.sum()

        self.timed(f"markov_fwd_{nm}", mk_fwd)
        self.timed(f"markov_grad_{nm}", mk_grad)

    def v_km_xla(self):
        self.timed("km_xla", lambda i: _flat_dot(km_se_d1_plain(self.x + i * 1e-7)))

    def v_km_pal(self):
        # one row: the TPU kernel's tilings, km_pal_256x2048 and
        # km_pal_512x1024, were VMEM choices with no meaning on the card
        self.timed("km_pal", lambda i: _flat_dot(km_se_d1(self.x + i * 1e-7)))

    # ---- the distributed tier on a one-rank 'rows' mesh -----------------------
    def _rows_mesh(self):
        """A one-rank 'rows' mesh: the job's group, or one made here (and
        destroyed when the probe's run ends)."""
        import torch.distributed as dist

        from stheno_tpu_torch.parallel import rows_mesh

        if not dist.is_initialized():
            self._own_group = True
        return rows_mesh(device_type=self.dev.type)

    def v_dist_p1(self):
        """The distributed factorisation and logpdf (`parallel.cholesky`) on
        a one-rank mesh, against the single-card route in the same run
        (reference `scripts/perf_probe.py:655-699`): the validation of the
        multi-card code that a one-card machine permits."""
        from stheno_tpu_torch.parallel import distributed_cholesky_auto, distributed_mvn_logpdf

        mesh = self._rows_mesh()
        y = torch.sin(self.x)
        zeros = torch.zeros_like(y)
        block = min(1024, self.n)

        def single_run(i):
            with torch.no_grad():
                return C.mvn_logpdf_chol(y, zeros, C.cholesky_psd(self.km(i)))

        def dist_run(i):
            with torch.no_grad():
                return distributed_mvn_logpdf(mesh, self.km(i), zeros, y, block_size=block)

        def dist_chol_run(i):
            with torch.no_grad():
                return _flat_dot(distributed_cholesky_auto(mesh, self.km(i), block_size=block))

        self.timed("logpdf_single", single_run)
        v_s, v_d = float(single_run(99)), float(dist_run(99))
        rel = abs(v_s - v_d) / abs(v_s)
        self.timed("logpdf_dist_p1", dist_run, extra={
            "single": v_s, "dist": v_d, "rel_diff_vs_single": rel, "ok": rel <= CHOL_RTOL})
        self.timed("chol_dist_p1", dist_chol_run, expect=self.trK)
        _log(f"dist_p1 value check: single {v_s:.6g} vs distributed {v_d:.6g} (rel {rel:.3g})")

    def v_ring_p1(self):
        """The matrix-free ring (`parallel.ring`: CG, SLQ logdet, the
        Hutchinson backward) on a one-rank mesh, forward and y-gradient,
        against the dense logpdf and −K̂⁻¹y in the same run (reference
        `scripts/perf_probe.py:700-752`; noise 1.0 keeps the SE system
        within f32 CG's reach)."""
        from stheno_tpu_torch.kernels import SEKernel, with_lengthscale
        from stheno_tpu_torch.parallel.ring import ring_gp_logpdf

        mesh = self._rows_mesh()
        kern = 1.5 * with_lengthscale(SEKernel(), 1.0)
        y = torch.sin(self.x)

        def ring(i, yy):
            gen = torch.Generator(device=self.dev).manual_seed(7)
            return ring_gp_logpdf(mesh, kern, self.x + i * 1e-7, yy, 1.0, gen, **RING_P1)

        def ring_fwd(i):
            with torch.no_grad():
                return ring(i, y)

        def ring_ygrad(i):
            yy = y.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(ring(i, yy), yy)
            return torch.dot(g, y)

        def dense_ref(i):
            with torch.no_grad():
                L = C.cholesky_psd(self.km(i, noise=1.0))
                alpha = C.chol_solve(L, y)
                return C.mvn_logpdf_chol(y, torch.zeros_like(y), L), alpha

        yy = y.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(ring(99, yy), yy)
        v_r = float(ring_fwd(99))
        v_d, alpha = dense_ref(99)
        v_d = float(v_d)
        rel_v = abs(v_r - v_d) / abs(v_d)
        rel_g = float(torch.max(torch.abs(g + alpha)) / torch.max(torch.abs(alpha)))
        g_r, g_d = float(torch.dot(g, y)), float(-torch.dot(alpha, y))
        self.timed("ring_p1_fwd", ring_fwd, extra={
            "dense": v_d, "rel_diff_vs_dense": rel_v, "ok": abs(v_r - v_d) <= 0.02 * abs(v_d) + 1.0})
        self.timed("ring_p1_ygrad", ring_ygrad, extra={
            "dense": g_d, "rel_diff_vs_dense": rel_g, "ok": rel_g <= RING_YGRAD_RTOL})
        _log(f"ring_p1 value check: ring {v_r:.6g} vs dense {v_d:.6g} (rel {rel_v:.3g}); "
             f"ygrad <g, y> ring {g_r:.6g} vs dense {g_d:.6g}, max|g + α| / max|α| {rel_g:.3g}")

    # ---- registry ----------------------------------------------------------
    def variants(self):
        """(selector, thunk) in the reference's order."""
        out = [("null", self.v_null), ("chol_lax", self.v_chol_lax), ("chol_cur", self.v_chol_cur),
               ("chol_high", self.v_chol_high), ("chol_grad", self.v_chol_grad)]
        out += [(g[0], lambda g=g: self.v_grad_ladder(*g)) for g in GRAD_LADDER]
        out += [(name, lambda name=name, p=p: self.v_chol_grad_bp(name, p))
                for name, p in (("chol_grad_bp_def", "default"), ("chol_grad_bp_high", "high"))]
        out += [("chol_impl_plain", self.v_chol_impl_plain), ("chol_impl_sym", self.v_chol_impl_sym),
                ("chol_psd_path", self.v_chol_psd_path)]
        out += [(f"chol_b{b}", lambda b=b: self.v_chol_blocks(b)) for b in (1024, 4096)]
        out += [(f"chol_f{b}_b{base}", lambda b=b, base=base: self.v_chol_fwd_ladder(b, base))
                for b, base in FWD_LADDER]
        out += [("chol_btri", self.v_chol_btri), ("chol_high_btri", self.v_chol_high_btri),
                ("chol_pal_base", self.v_chol_pal_base),
                ("chol_pal_all", self.v_chol_pal_all), ("base_chain", self.v_base_chain),
                ("trsm", self.v_trsm), ("subst_width", self.v_subst_width),
                ("logpdf_fwd", self.v_logpdf_fwd),
                ("bench_kgrad", self.v_bench_kgrad), ("bench_hgrad", self.v_bench_hgrad),
                ("accuracy", self.v_accuracy), ("gemm_peak", self.v_gemm_peak),
                ("fwd_floor", self.v_fwd_floor), ("dist_p1", self.v_dist_p1),
                ("ring_p1", self.v_ring_p1), ("markov_1m", self.v_markov_1m),
                ("km_xla", self.v_km_xla), ("km_pal", self.v_km_pal)]
        return out

    def run(self, selected=()):
        """Run the selected variants (all when empty) in the reference's
        order; returns the rows by name."""
        table = self.variants()
        unknown = set(selected) - {name for name, _ in table}
        if unknown:
            raise ValueError(f"unknown variants {sorted(unknown)}; known: {[n for n, _ in table]}")
        _log(f"device: {self.dev}"
             + (f" ({torch.cuda.get_device_name(self.dev)})" if self.dev.type == "cuda" else "")
             + f"  N={self.n}  reps={self.reps}")
        try:
            for name, thunk in table:
                if not selected or name in selected:
                    thunk()
                    if self.dev.type == "cuda":
                        torch.cuda.empty_cache()
        finally:
            if self._own_group:
                import torch.distributed as dist

                dist.destroy_process_group()
                self._own_group = False
        return self.results

    def summary(self):
        _log("---- summary (median ms) ----")
        timed = [(k, r["median_ms"]) for k, r in self.results.items() if "median_ms" in r]
        for k, ms in sorted(timed, key=lambda kv: kv[1]):
            _log(f"{k:24s} {ms:10.3f}")
        if self.failures:
            _log(f"FAILED checks: {self.failures}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m stheno_tpu_torch.perf_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help="variant or group names (default: all)")
    ap.add_argument("--n", type=int, default=16384, help="N of the dense rows (default 16384)")
    ap.add_argument("--reps", type=int, default=4, help="timed calls per row (default 4)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--markov-n", type=int, default=1_000_000, help="N of markov_1m (default 10^6)")
    args = ap.parse_args(argv)
    probe = Probe(args.n, args.reps, args.device, args.markov_n)
    probe.run(tuple(args.variants))
    probe.summary()
    return 1 if probe.failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""Layout study: the 1-D slab, the 1-D row-cyclic and a masked 2-D
block-cyclic distributed Cholesky (counterpart of `scripts/layout_study.py`;
a study, not a library path).

`parallel/cholesky.py` factors in a 1-D row layout and not in the 2-D
('row', 'col') block-cyclic one that a ScaLAPACK-style code would take.
The argument: a 2-D layout's ~N³/(6P) multiply-adds a rank need each rank
to update only its lower-triangle tiles (i ≥ j), a set that depends on the
(row-rank, col-rank) pair, so one SPMD program of fixed shapes cannot
express it; the fixed-shape alternative updates the whole active rows ×
active columns rectangle and masks the upper half away, which costs
Σ_k ((N − c)/Pr)·B·((N − c)/Pc) = N³/(3P), the row-cyclic layout's count.

This turns the argument into numbers.  It runs the masked 2-D prototype
(`chol_2d_loop`: the diagonal tile broadcast over both axes, the masked
panel solve, the panel's row and column exchanges, the full-rectangle
trailing update) on a near-square grid, and counts each rank's matrix-
product FLOPs (`utils.cost`, PyTorch's `FlopCounterMode`: 2 a multiply-add;
factorisations and triangular solves are not counted) of the port's slab
and cyclic factors and of the prototype, beside the analytic multiply-add
floors N³/(2P) and N³/(3P) and the collective traffic's word counts.  The
counts do not depend on the device: take them on the CPU over gloo.

    python -m stheno_tpu_torch.layout_study --p 8 --n 2048 --block 128 --device cpu
    python -m stheno_tpu_torch.layout_study --p 1 --check          # on the card

With P > 1 it starts P ranks itself (one process each, a `file://` store in
a temporary directory) and prints rank 0's JSON line; with P = 1 it runs in
this process on a one-rank group.  `--check` holds the prototype's factor
against `np.linalg.cholesky` in f64 (relative error below 1e-4, the f32
limit) instead of counting.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from stheno_tpu_torch.ops import chol as _chol
from stheno_tpu_torch.ops.blocked_cholesky import _mm
from stheno_tpu_torch.parallel.collectives import Axis, all_gather, psum

#: seconds the ranks of a study may take, start-up included
JOIN_TIMEOUT = 900
#: the `--check` limit on max|L − L_ref| / max|L_ref|
CHECK_TOL = 1e-4


def grid(p):
    """Near-square (Pr, Pc) factorisation of p."""
    pr = int(np.sqrt(p))
    while p % pr != 0:
        pr -= 1
    return max(pr, 1), p // max(pr, 1)


def _ceil_div(a, b):
    return -(-a // b)


def global_ids(rank, slots, p, B, device):
    """The global row (or column) index of each of `slots`·B local positions
    of a rank in the block-cyclic layout over p ranks."""
    i = torch.arange(slots * B, device=device)
    return (rank + (i // B) * p) * B + i % B


def chol_2d_loop(K_loc, block_size, n_total, row_ax, col_ax):
    """The masked 2-D block-cyclic Cholesky of this rank's (N/Pr, N/Pc)
    tile set: tile (I, J) lives on rank (I mod Pr, J mod Pc).  Per panel k
    the active local rows and columns are fixed slot ranges, the same on
    every rank up to one masked boundary block; the j ≤ i triangle is
    masked, not skipped.  Returns this rank's tiles of L."""
    pr, pc = row_ax.size, col_ax.size
    B = block_size
    nb = n_total // B
    mr, mc = nb // pr, nb // pc  # local row and column slots
    dev = K_loc.device
    g_rows = global_ids(row_ax.rank, mr, pr, B, dev)
    g_cols = global_ids(col_ax.rank, mc, pc, B, dev)
    K_loc = K_loc.clone()
    for k in range(nb):
        c = k * B
        sr, sc = k // pr, k // pc  # the diagonal tile's local slots
        mine = row_ax.rank == k % pr and col_ax.rank == k % pc
        col_owner = col_ax.rank == k % pc
        # the diagonal tile, broadcast over both axes by sums
        contrib = K_loc[sr * B:(sr + 1) * B, sc * B:(sc + 1) * B]
        diag = psum(psum(contrib if mine else torch.zeros_like(contrib), row_ax), col_ax)
        L_kk = _chol.cholesky_psd(diag)
        if mine:
            K_loc[sr * B:(sr + 1) * B, sc * B:(sc + 1) * B] = L_kk
        # the panel column below the diagonal, on the column's owners
        tr = max(0, _ceil_div(k + 2 - pr, pr))  # first active local row slot
        if tr >= mr:
            continue
        rs = tr * B
        m_act = mr * B - rs
        below = (g_rows[rs:] >= c + B)[:, None]
        A_act = K_loc[rs:, sc * B:(sc + 1) * B]
        P_act = _chol.solve_lower(L_kk, A_act.T).T
        keep = below & col_owner
        new_act = torch.where(keep, P_act, torch.zeros_like(P_act))
        K_loc[rs:, sc * B:(sc + 1) * B] = torch.where(keep, P_act, A_act)
        if c + B >= n_total:
            continue
        # the row factor of my rows: the owners' panel, summed along 'col'
        Lrow = psum(new_act, col_ax)  # (m_act, B)
        # the column factor of my columns: the whole active panel, gathered
        # over 'row', read at my columns' global ids
        flat = all_gather(Lrow, row_ax)  # (Pr·m_act, B)
        tc = max(0, _ceil_div(k + 2 - pc, pc))  # first active local column slot
        if tc >= mc:
            continue
        cs = tc * B
        gc = g_cols[cs:]
        gblk = gc // B
        idx = (gblk % pr) * m_act + (gblk // pr - tr) * B + gc % B
        Lcol = flat[torch.clamp(idx, 0, pr * m_act - 1)]
        Lcol = torch.where((gc >= c + B)[:, None], Lcol, torch.zeros_like(Lcol))
        # the trailing update over the whole active rectangle: the upper
        # half is computed and masked, the fixed-shape program's cost
        upd = _mm(torch.where(below, Lrow, torch.zeros_like(Lrow)), Lcol.T)
        K_loc[rs:, cs:] = K_loc[rs:, cs:] - upd
    return torch.where(g_cols[None, :] <= g_rows[:, None], K_loc, torch.zeros_like(K_loc))


def local_tiles(K, B, row_rank, col_rank, pr, pc):
    """This rank's tiles of a whole (N, N) K in the 2-D block-cyclic layout."""
    n = K.shape[0]
    rows = global_ids(row_rank, n // B // pr, pr, B, K.device)
    cols = global_ids(col_rank, n // B // pc, pc, B, K.device)
    return K[rows[:, None], cols[None, :]]


def spd_matrix(n, seed=0):
    """A A^T + n·I, A standard normal from numpy `seed` (f64)."""
    A = np.random.default_rng(seed).normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


def _counted_flops(fn):
    from stheno_tpu_torch.utils.cost import cost_analysis

    with torch.no_grad():
        return cost_analysis(fn)["flops"]


def study(p, n, block, check=False, dtype=torch.float32, device="cpu"):
    """The study on this rank of a P-rank group: with `check`, the
    prototype's factor against `np.linalg.cholesky` (and the whole factor,
    under "factor", on every rank); else every rank's counted FLOPs of the
    three factorisations, the multiply-add floors and the word counts."""
    from stheno_tpu_torch.parallel import distributed_cholesky, distributed_cholesky_cyclic
    from stheno_tpu_torch.parallel.multihost import global_mesh

    dev = torch.device(device)
    if dist.get_world_size() != p:
        raise ValueError(f"the study at P={p} in a group of {dist.get_world_size()} ranks")
    pr, pc = grid(p)
    B = block
    if n % B or (n // B) % pr or (n // B) % pc:
        raise ValueError(f"N={n}, block {B}: the block count must divide over a {pr} × {pc} grid")
    mesh2 = global_mesh(("row", "col"), (pr, pc), device_type=dev.type)
    row_ax, col_ax = Axis(mesh2, "row"), Axis(mesh2, "col")
    K64 = spd_matrix(n)
    K = torch.as_tensor(K64, dtype=dtype, device=dev)
    K_loc2 = local_tiles(K, B, row_ax.rank, col_ax.rank, pr, pc)
    out = {"p": p, "grid": [pr, pc], "n": n, "block": B, "dtype": str(dtype).replace("torch.", "")}

    if check:
        with torch.no_grad():
            L_loc = chol_2d_loop(K_loc2, B, n, row_ax, col_ax)
            rows = global_ids(row_ax.rank, n // B // pr, pr, B, dev)
            cols = global_ids(col_ax.rank, n // B // pc, pc, B, dev)
            whole = torch.zeros((n, n), dtype=dtype, device=dev)
            whole[rows[:, None], cols[None, :]] = L_loc
            L = psum(psum(whole, row_ax), col_ax).cpu().double().numpy()
        L_ref = np.linalg.cholesky(K64)
        err = float(np.abs(L - L_ref).max() / np.abs(L_ref).max())
        print(f"2-D prototype vs dense: rel err {err:.2e}", file=sys.stderr, flush=True)
        if not err < CHECK_TOL:
            raise RuntimeError(f"the 2-D prototype's factor is off by {err:.2e} (limit {CHECK_TOL})")
        out.update(check="ok", rel_err=err, factor=L)
        return out

    mesh1 = global_mesh(("rows",), device_type=dev.type)
    rows_ax = Axis(mesh1, "rows")
    a, b = rows_ax.rows(n)
    K_slab = K[a:b]
    mine = {
        "slab": _counted_flops(lambda: distributed_cholesky(mesh1, K_slab, block_size=B)),
        "cyclic": _counted_flops(lambda: distributed_cholesky_cyclic(mesh1, K_slab, block_size=B)),
        "masked2d": _counted_flops(lambda: chol_2d_loop(K_loc2, B, n, row_ax, col_ax)),
    }
    # every rank's counts, in rank order (the 2-D grid's ranks are the job's)
    counts = all_gather(torch.tensor([list(mine.values())], dtype=torch.float64, device=dev),
                        rows_ax).cpu().numpy()
    for j, name in enumerate(mine):
        out[f"{name}_flops"] = float(counts[:, j].max())  # the busiest rank's
        out[f"{name}_flops_per_rank"] = counts[:, j].tolist()
        out[f"{name}_macs"] = out[f"{name}_flops"] / 2
    # analytic multiply-add floors (per rank) and collective word counts
    out["floor_slab"] = n**3 / (2 * p)
    out["floor_rowcyclic"] = n**3 / (3 * p)
    out["floor_2d_masked"] = n**3 / (3 * p)
    out["floor_2d_triangle_unreachable"] = n**3 / (6 * p)
    for name, floor in (("slab", "floor_slab"), ("cyclic", "floor_rowcyclic"),
                        ("masked2d", "floor_2d_masked")):
        out[f"{name}_macs_over_floor"] = out[f"{name}_macs"] / out[floor]
    # words a rank receives by collectives, to leading order:
    #   slab and row-cyclic: the panel all_gather, Σ_k (N − c)·B ≈ N²/2;
    #   2-D: the panel broadcast over 'col' (N/Pr · B · nb = N²/Pr) and the
    #   gather over 'row' (≈ N²/2: the column factor still needs the whole
    #   trailing panel height on every rank)
    out["comm_words_slab"] = n * n / 2
    out["comm_words_cyclic"] = n * n / 2
    out["comm_words_2d"] = n * n / 2 + n * n / pr
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m stheno_tpu_torch.layout_study",
                                 description="Slab, row-cyclic and masked 2-D distributed "
                                             "Cholesky: per-rank FLOPs, or --check.")
    ap.add_argument("--p", type=int, default=8, help="ranks (started here when P > 1)")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--check", action="store_true",
                    help="the 2-D prototype's factor against the dense one")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--device", default="cuda", help="'cuda' (default; NCCL) or 'cpu' (gloo)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _run_here(args, dev):
    from stheno_tpu_torch.parallel import multihost

    made_group = not dist.is_initialized()
    multihost.ensure_group(dev.type)
    try:
        return study(args.p, args.n, args.block, args.check, getattr(torch, args.dtype), dev)
    finally:
        if made_group:
            dist.destroy_process_group()


def _rank_main(args, dev):
    """One rank of a study that `_start_ranks` started."""
    from stheno_tpu_torch.parallel import multihost

    store = Path(args.store)
    multihost.initialize(f"file://{store / 'store'}", num_processes=args.p, process_id=args.rank,
                         device_type=dev.type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    try:
        out = study(args.p, args.n, args.block, args.check, getattr(torch, args.dtype), dev)
        with open(store / f"out{args.rank}.pkl", "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def _start_ranks(argv, args):
    """Run the study in P processes of this module; rank 0's result."""
    store = Path(tempfile.mkdtemp(prefix="layout_study-"))
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(repo), env.get("PYTHONPATH")]))
    procs = []
    try:
        for r in range(args.p):
            log = open(store / f"rank{r}.log", "w")
            cmd = [sys.executable, "-m", "stheno_tpu_torch.layout_study", *argv,
                   "--rank", str(r), "--store", str(store)]
            procs.append((subprocess.Popen(cmd, cwd=repo, env=env, stdout=log,
                                           stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + JOIN_TIMEOUT
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        bad = [r for r, (proc, _) in enumerate(procs) if proc.returncode != 0]
        if bad:
            tails = "\n".join(f"--- rank {r} ---\n" + (store / f"rank{r}.log").read_text()[-3000:]
                              for r in bad)
            raise RuntimeError(f"layout_study: ranks {bad} failed:\n{tails}")
        with open(store / "out0.pkl", "rb") as f:
            return pickle.load(f)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(store, ignore_errors=True)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse(argv)
    from stheno_tpu_torch.convert import resolve_device

    dev = resolve_device(args.device)
    if args.rank is not None:
        return _rank_main(args, dev)
    out = _run_here(args, dev) if args.p == 1 else _start_ranks(argv, args)
    print(json.dumps({k: v for k, v in out.items() if k != "factor"}), flush=True)
    return out


if __name__ == "__main__":
    main()

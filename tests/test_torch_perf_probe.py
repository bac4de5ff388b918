"""The port's performance probe (`stheno_tpu_torch.perf_probe`) on the CPU at
N = 512, one timed call per row: every ported variant runs and passes its
checks (gemm_peak, fixed at 8k and 16k, only has its TF32 switch checked),
and kernel 4's plain version matches the reference probe's Pallas kernel
(`scripts/perf_probe.py:make_km_pallas`) in interpret mode."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stheno_tpu_torch import cuda as kern
from stheno_tpu_torch import perf_probe
from stheno_tpu_torch.cuda.kernelmatrix import km_se_d1
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
VARIANTS = [name for name, _ in perf_probe.Probe(n=8, device="cpu").variants()]


def _run(capsys, *args):
    rc = perf_probe.main(["--device", "cpu", "--n", "512", "--reps", "1", "--markov-n", "2048", *args])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    return rc, rows


@pytest.mark.parametrize("variant", [v for v in VARIANTS if v != "gemm_peak"])
def test_variant_runs_and_passes_its_checks(variant, capsys):
    rc, rows = _run(capsys, variant)
    assert rc == 0 and rows
    for row in rows:
        assert row["ok"] and row["device"] == "cpu", row
        assert math.isfinite(row["scalar"]), row
        if "median_ms" in row:
            assert len(row["ms"]) == 1 and row["median_ms"] > 0
        if "expect" in row:  # the Cholesky rows: ΣL² = tr(K)
            assert row["rel_err"] <= perf_probe.CHOL_RTOL, row
        if "grad_max_abs_err_vs_I" in row:
            assert row["grad_max_abs_err_vs_I"] <= perf_probe.GRAD_ATOL, row
    names = {row["variant"] for row in rows}
    if variant == "markov_1m":
        assert names == {"markov_fwd_2048", "markov_grad_2048"}
    if variant == "chol_cur":
        assert rows[0]["expect"] == pytest.approx(512 * 1.6)


def test_groups_run_every_row(capsys):
    rc, rows = _run(capsys, "base_chain", "trsm", "fwd_floor")
    assert rc == 0
    assert [r["variant"] for r in rows] == [
        "base_chain_lax", "base_chain_pal", "trsm_lax", "trsm_blocked", "trsm_lax_grad",
        "trsm_blocked_grad", "fwd_now", "gemm_shapes", "diag_chain", "diag_chain_lax", "fwd_floor"]
    by = {r["variant"]: r for r in rows}
    assert by["base_chain_pal"]["scalar"] == pytest.approx(by["base_chain_lax"]["scalar"], rel=1e-5)
    assert by["trsm_blocked"]["scalar"] == pytest.approx(by["trsm_lax"]["scalar"], rel=1e-5)


def test_distributed_rows_run_on_a_one_rank_group_and_leave_none(capsys):
    """dist_p1 and ring_p1 make a one-rank gloo group on the CPU, check the
    distributed logpdf against the single-card one and the ring's logpdf
    and y-gradient against dense, and destroy the group when done."""
    import torch.distributed as dist

    rc, rows = _run(capsys, "dist_p1", "ring_p1")
    assert rc == 0 and not dist.is_initialized()
    by = {r["variant"]: r for r in rows}
    assert list(by) == ["logpdf_single", "logpdf_dist_p1", "chol_dist_p1", "ring_p1_fwd",
                        "ring_p1_ygrad"]
    assert by["logpdf_dist_p1"]["rel_diff_vs_single"] <= perf_probe.CHOL_RTOL
    assert by["chol_dist_p1"]["rel_err"] <= perf_probe.CHOL_RTOL
    assert by["ring_p1_ygrad"]["rel_diff_vs_dense"] <= perf_probe.RING_YGRAD_RTOL
    assert perf_probe.RING_P1 == dict(num_probes=8, lanczos_iters=20, tol=1e-6, maxiter=400)


def test_ladder_bases_beyond_the_kernels_take_the_library(capsys):
    rc, rows = _run(capsys, "chol_f1024_b256", "chol_f1024_b512")
    assert rc == 0
    assert [r["base_cases"] for r in rows] == ["kernels 2 and 3", "library (too large for kernels 2 and 3)"]


def test_the_base_switch_follows_the_kernels_shared_memory(monkeypatch):
    """The probe asks kernels 2 and 3 which blocks they take: n ≤ 288 for
    each in 227 KiB (their 32×32 tiles and the transposed panel beside
    them); with more shared memory, base 512 would stay on the kernels."""
    from stheno_tpu_torch.cuda import chol_block as cb

    assert cb._fits("chol_block", 288) and not cb._fits("chol_block", 289)
    # 36 lower tiles, 7 panel tiles, the transposed diagonal factor, 96 floats
    assert cb._smem_bytes("chol_block", 256) == ((36 + 7 + 1) * 32 * 32 + 96) * 4 == 180608
    assert cb._fits("tri_inv_block", 288) and not cb._fits("tri_inv_block", 289)
    # 36 lower tiles, 7 panel tiles, the transposed diagonal inverse
    assert cb._smem_bytes("tri_inv_block", 256) == (36 + 7 + 1) * 32 * 32 * 4 == 180224
    assert cb.fits(288) and not cb.fits(289)
    assert perf_probe.base_scope(256) == {} and perf_probe.base_scope(512) == perf_probe.LIBRARY_BASE
    monkeypatch.setattr(cb, "SMEM_LIMIT", 4 * 2**20)
    assert perf_probe.base_scope(512) == {} and perf_probe.base_scope(1024) == {}


def test_gradient_limits():
    """Every backward mode is held to GRAD_ATOL, but the fused sweep at
    panels over 2048 (its default is 4096), which has its own limit."""
    wide = perf_probe.WIDE_FUSED_GRAD_ATOL
    assert perf_probe.GRAD_ATOL < wide
    assert perf_probe.grad_atol() == perf_probe.GRAD_ATOL
    assert perf_probe.grad_atol({"mode": "iter", "block": 8192}) == perf_probe.GRAD_ATOL
    assert perf_probe.grad_atol({"mode": "fused", "block": 2048}) == perf_probe.GRAD_ATOL
    assert perf_probe.grad_atol({"mode": "fused", "block": 4096}) == wide
    assert perf_probe.grad_atol({"mode": "fused"}) == wide
    rows = {name: perf_probe.grad_atol(dict(mode=mode, block=block))
            for name, _, _, _, mode, block in perf_probe.GRAD_LADDER}
    assert [name for name, atol in rows.items() if atol == wide] == ["chol_grad_fused4096"]


def test_a_failed_check_exits_nonzero(capsys, monkeypatch):
    """A factor of K + 0.2·I is checked against tr(K + 0.1·I): the row
    fails, and the probe exits with 1."""
    km = perf_probe.Probe.km
    monkeypatch.setattr(perf_probe.Probe, "km", lambda self, i, noise=0.1: km(self, i, noise + 0.1))
    rc, rows = _run(capsys, "chol_cur")
    assert rc == 1 and not rows[0]["ok"] and rows[0]["rel_err"] > 0.05


def test_gemm_peak_restores_the_tf32_switch(monkeypatch):
    """gemm_peak switches TF32 on for its own GEMMs only, and restores the
    switch even when a row raises (here, the first TF32 row)."""

    def timed(self, name, fn, **kw):
        if name == "gemm_tf32_8k":
            assert torch.backends.cuda.matmul.allow_tf32 is True
            raise RuntimeError("stop")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        return {"tflops": 0.0}

    monkeypatch.setattr(perf_probe.Probe, "timed", timed)
    monkeypatch.setattr(torch, "arange", lambda n, **kw: torch.zeros(n, **kw)[:8])
    probe = perf_probe.Probe(n=8, device="cpu")
    with pytest.raises(RuntimeError, match="stop"):
        probe.v_gemm_peak()
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_unknown_variants_and_no_card_raise(monkeypatch):
    with pytest.raises(ValueError, match="unknown variants"):
        perf_probe.Probe(n=8, device="cpu").run(("chol_nonexistent",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        perf_probe.main(["--n", "8", "null"])


def test_km_se_d1_on_the_cpu_is_the_plain_version_and_counts_nothing():
    kern.reset_counters()
    x = torch.linspace(-5.0, 5.0, 300)
    K = km_se_d1(x)
    d = x[:, None] - x[None, :]
    torch.testing.assert_close(K, 1.5 * torch.exp(-0.5 * d * d), rtol=0, atol=0)
    assert bool((K.diagonal() == 1.5).all())
    assert kern.COUNTERS["km_se_d1"].total == 0 and kern.COUNTERS["kernelmatrix"].total == 0
    with pytest.raises(ValueError):
        km_se_d1(x[:, None])


# The reference probe updates JAX's global config and builds its inputs when
# it is imported, so it runs in a subprocess, on the CPU at PROBE_N = 2048
# (a multiple of both of its tilings).  Its kernel `km` is a closure of the
# jitted function `make_km_pallas` returns.
_REFERENCE_KM = """
import importlib.util, sys
import jax
import numpy as np

# keep the reference script's persistent compilation cache (a fixed path
# outside the checkout) off
_update = jax.config.update
jax.config.update = lambda k, v: None if "cache" in k else _update(k, v)
spec = importlib.util.spec_from_file_location("reference_perf_probe", "scripts/perf_probe.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
out = {}
for tm, tn in [(256, 2048), (512, 1024)]:
    run = mod.make_km_pallas(tm, tn)
    km = next(c.cell_contents for c in run.__wrapped__.__closure__
              if getattr(c.cell_contents, "__name__", "") == "km")
    out[f"K_{tm}x{tn}"] = np.asarray(km(mod.x_host + 1e-7))
np.savez(sys.argv[1], x=np.asarray(mod.x_host + 1e-7), **out)
"""


def test_km_se_d1_matches_the_reference_pallas_kernel_in_interpret_mode(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PROBE_CPU="1", PROBE_N="2048", JAX_PLATFORMS="cpu")
    out = tmp_path / "km.npz"
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_KM, str(out)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ref = np.load(out)
    x = torch.from_numpy(ref["x"])
    assert x.dtype == torch.float32 and x.shape == (2048,)
    K = km_se_d1(x).numpy()
    for tiles in ("256x2048", "512x1024"):
        # f32 exp in XLA and in PyTorch: values in [0, 1.5]
        np.testing.assert_allclose(K, ref[f"K_{tiles}"], rtol=0, atol=1e-6)
    assert np.all(np.diagonal(K) == np.float32(1.5))

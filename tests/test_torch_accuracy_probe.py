"""The accuracy probe's routes (`stheno_tpu_torch.accuracy_probe`) on the CPU:
each scopes what it names and undoes it, and the one-GEMM update it swaps
in computes the same factor as the port's panel-by-panel update (f64,
1e-12 relative, both against `torch.linalg.cholesky`)."""

import numpy as np
import pytest
import torch

import stheno_tpu_torch as stt
from stheno_tpu_torch import accuracy_probe
from stheno_tpu_torch.ops import blocked_cholesky as bc
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3.0, 3.0, n))
    K = np.exp(-0.5 * np.subtract.outer(x, x) ** 2 / 0.3**2) + 1e-2 * np.eye(n)
    return torch.as_tensor(K)


@pytest.mark.parametrize("name", accuracy_probe.ROUTES)
def test_each_route_scopes_its_factor_and_undoes_it(name):
    kept = bc._left_update
    with accuracy_probe.route(name):
        backend = stt.config.active_override("chol_backend", "auto")
        bases = stt.config.active_override("base_cholesky", None)
        swapped = bc._left_update is not kept
    assert backend == ("torch" if name == "cusolver" else "blocked")
    assert (bases is bc.torch_chol_lower) == (name == "library_bases")
    assert swapped == (name == "one_gemm")
    assert bc._left_update is kept
    assert stt.config.active_override("chol_backend", "auto") == "auto"


def test_one_gemm_update_computes_the_same_factor():
    """n = 1024 with panels of 256: three earlier panels in the last update,
    and the inner recursion's own updates."""
    K = _spd(1024, 0)
    want = torch.linalg.cholesky(K)
    with accuracy_probe.route("port"):
        panel = bc._blocked_cholesky_impl(K, block=256, base=64)
    with accuracy_probe.route("one_gemm"):
        one = bc._blocked_cholesky_impl(K, block=256, base=64)
    for L in (panel, one):
        torch.testing.assert_close(L, want, rtol=1e-12, atol=1e-12 * want.abs().max().item())


def test_precision_rows_run_every_pair_on_the_cpu(capsys):
    """The precision part at N = 512 (one seed) and the NUTS rows at
    M = 256 on the CPU: a row for each (gemm, bwd) pair of both paths and
    each position and precision, all finite; below 'default' the value
    within 1e-4 of f64 and the factor's backward error within 1e-5."""
    import json

    assert accuracy_probe.main(["--device", "cpu", "--n", "512", "--seeds", "1", "--nuts-n", "256",
                                "--part", "precision"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    prec = [r for r in rows if r["row"] == "precision"]
    pairs = {(g, b) for g in accuracy_probe.PRECISIONS for b in accuracy_probe.PRECISIONS}
    for path in ("flagship", "derivative"):
        assert {(r["gemm"], r["bwd"]) for r in prec if r["path"] == path} == pairs
    for r in prec:
        if r["gemm"] != "default":
            assert r["factor_bwd_err"] <= 1e-5 and r["value_err"] <= 1e-4, r
        assert all(np.isfinite(v) for v in r["grad_err"].values()) or "default" in (r["gemm"], r["bwd"])
    nuts = [r for r in rows if r["row"] == "nuts_precision"]
    assert len(nuts) == 2 * accuracy_probe.NUTS_CHAINS
    assert {r["precision"] for r in nuts} == {"highest", "high"}
    assert all(np.isfinite(e) for r in nuts for e in r["grad_err"].values())
    assert rows[-1]["row"] == "precision_summary" and rows[-1]["nuts_n"] == 256
    assert stt.config.active_override("gemm_precision", None) is None


def test_chunk_rows_run_every_variant_on_the_cpu(capsys):
    """The chunk part at N = 512 (one seed) on the CPU: a row for 'highest'
    and each variant of 'high', all finite, the value within 1e-4 of f64;
    `_products` is restored after each.  At a chunk past the inner
    dimensions the swapped products equal the port's own 'high' products
    bit for bit."""
    import json

    kept = bc._products
    assert accuracy_probe.main(["--device", "cpu", "--n", "512", "--seeds", "1",
                                "--part", "chunks"]) == 0
    assert bc._products is kept
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [r["variant"] for r in rows] == ["highest"] + [c[0] for c in accuracy_probe.CHUNKS]
    for r in rows:
        assert r["flagship_value_err"] <= 1e-4 and r["derivative_seed0"]["value_err"] <= 1e-4, r
        assert all(np.isfinite(e) for e in r["flagship_grad_err"].values())
        assert all(np.isfinite(e) for e in r["derivative_mean_err"].values())
    g = torch.Generator().manual_seed(3)
    a, b = torch.randn(64, 200, generator=g), torch.randn(200, 48, generator=g)
    P = stt.config.Precision
    with accuracy_probe.high_products(256, False):
        swapped = bc._products(a, b, P.HIGH)
    assert torch.equal(swapped, bc._products(a, b, P.HIGH))

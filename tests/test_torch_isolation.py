"""The port stands alone and runs where its caller says: it imports neither
JAX nor the JAX package, its entry points default to CUDA and refuse to run
without it, and a CPU tensor takes the plain versions without touching the
launch counters."""

import ast
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import stheno_tpu_torch as stt
from stheno_tpu_torch import cuda as kern
from stheno_tpu_torch import accuracy_probe, entry, markov, params, parallel, perf_probe
from stheno_tpu_torch.convert import (
    chain_state_from_numpy,
    fourier_basis_from_numpy,
    likelihood_from_numpy,
    nkn_layers_from_numpy,
    spec_from_numpy,
    svgp_from_numpy,
    theta_from_numpy,
    warmup_state_from_numpy,
)
from stheno_tpu_torch.cuda import _build
from stheno_tpu_torch.examples import MODULES as EXAMPLE_MODULES
from stheno_tpu_torch.parallel import multihost
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
# the package, and what runs on the card without JAX
PORT_SOURCES = sorted((REPO / "stheno_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py"]
MODULES = sorted(
    "stheno_tpu_torch." + ".".join(p.relative_to(REPO / "stheno_tpu_torch").with_suffix("").parts)
    for p in (REPO / "stheno_tpu_torch").rglob("*.py")
    if p.name != "__init__.py"
)


def _forbidden(module: str) -> bool:
    """jax itself, or the JAX package (but not the port, whose name starts
    with the same letters)."""
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "stheno_tpu")


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'stheno_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        for name in names:
            assert not _forbidden(name), f"{path.name}:{node.lineno} imports {name}"


def test_forbidden_tells_the_jax_package_from_the_port():
    assert _forbidden("stheno_tpu") and _forbidden("stheno_tpu.ops.chol") and _forbidden("jax.numpy")
    assert not _forbidden("stheno_tpu_torch") and not _forbidden("stheno_tpu_torch.ops")


@pytest.mark.parametrize("name", ["markov", "perf_probe", "params", "inference/vi", "models/workloads",
                                  "utils/testing", "entry", "convert", "finite_gp", "ops/chol",
                                  "inference/svgp", "inference/likelihoods", "inference/laplace",
                                  "inference/hmc", "inference/smc", "inference/diagnostics",
                                  "inference/checkpoint", "func_transforms", "tree", "sampling",
                                  "kernels/nkn", "graph", "accuracy_probe", "parallel/collectives",
                                  "parallel/mesh", "parallel/cholesky", "parallel/big", "parallel/gppp", "parallel/ring", "parallel/svgp",
                                  "parallel/chains", "parallel/multihost", "utils/cost",
                                  "utils/logging", "examples/_common",
                                  "examples/process_decomposition", "examples/naive_linear_mixing",
                                  "examples/time_varying_blr", "examples/sensor_fusion",
                                  "examples/custom_affine_transformations",
                                  "examples/convolutional_gp", "examples/deep_kernel_learning",
                                  "examples/getting_started", "examples/non_gaussian_likelihoods",
                                  "examples/markov_time_series", "cuda/tf32_split", "config",
                                  "ops/blocked_cholesky", "multichip", "nuts_bench", "nuts_pool",
                                  "smc_bench", "layout_study"])
def test_the_new_modules_are_walked(name):
    assert REPO / "stheno_tpu_torch" / f"{name}.py" in PORT_SOURCES
    assert "stheno_tpu_torch." + name.replace("/", ".") in MODULES


@pytest.mark.parametrize("call", [
    lambda: entry.flagship(512),
    lambda: entry.flagship_data(512),
    lambda: theta_from_numpy({"v": np.ones(())}),
    lambda: perf_probe.Probe(n=8),
    lambda: perf_probe.main(["--n", "8", "null"]),
    lambda: accuracy_probe.main(["--n", "64"]),
    lambda: markov.markov_gp_logpdf(stt.Matern32Kernel(), np.linspace(0, 1, 5), np.zeros(5), 0.1),
    lambda: markov.sde_representation(stt.Matern32Kernel()),
    lambda: entry.mauna_loa_data(),
    lambda: entry.mauna_loa_spec(),
    lambda: entry.mauna_loa_fit(1),
    lambda: spec_from_numpy({"a": np.ones(())}),
    lambda: entry.pseudo_points_data(),
    lambda: entry.pseudo_points_fit(1),
    lambda: svgp_from_numpy(type("Q", (), {"q_mu": np.zeros(2), "q_sqrt": np.eye(2)})(), None),
    lambda: likelihood_from_numpy(stt.inference.BernoulliLikelihood()),
    lambda: entry.nuts_data(),
    lambda: entry.nuts_run(1, 1),
    lambda: entry.smc_data(),
    lambda: entry.smc_particles(),
    lambda: chain_state_from_numpy(stt.inference.ChainState(*[np.zeros(2)] * 5)),
    lambda: warmup_state_from_numpy(type("W", (), dict(
        q=np.zeros(2), logp=np.zeros(()), grad=np.zeros(2), inv_mass=np.ones(2),
        da=type("D", (), dict.fromkeys(("log_eps", "log_eps_avg", "grad_avg", "t", "mu"), 0.0))(),
        wf=type("F", (), dict.fromkeys(("count", "mean", "m2"), 0.0))()))()),
    lambda: entry.derivative_data(64),
    lambda: entry.deconvolution_data(64),
    lambda: entry.nkn_data(),
    lambda: entry.nkn_example(1),
    lambda: entry.differentiation_example(),
    lambda: entry.quadrature_convolution_example(),
    lambda: nkn_layers_from_numpy([stt.LinearLayer(np.zeros((1, 2)))]),
    lambda: fourier_basis_from_numpy(type("B", (), dict(
        omega=np.zeros((2, 1)), phase=np.zeros(2), scale=np.ones(2)))()),
    lambda: entry.big_n_sharded_example(),
    lambda: entry.matrix_free_example(),
    lambda: entry.matrix_free_data(64),
    lambda: entry.svgp_data_parallel_example(),
    lambda: entry.svgp_dp_data(64),
    lambda: parallel.rows_mesh(),
    lambda: parallel.chains_mesh(),
    lambda: parallel.data_mesh(),
    lambda: parallel.grid_mesh(1, 1),
    lambda: multihost.global_mesh(),
    lambda: multihost.initialize("file:///nonexistent/store", 1, 0),
    lambda: entry.mauna_loa_example(1),
    lambda: entry.pseudo_points_example(1),
    lambda: entry.nuts_example(1, 1),
    lambda: entry.smc_example(8),
    *[lambda name=name: importlib.import_module(f"stheno_tpu_torch.examples.{name}").main()
      for name in EXAMPLE_MODULES],
], ids=["flagship", "flagship_data", "theta_from_numpy", "perf_probe", "perf_probe_main",
        "accuracy_probe_main",
        "markov_gp_logpdf", "sde_representation", "mauna_loa_data", "mauna_loa_spec",
        "mauna_loa_fit", "spec_from_numpy", "pseudo_points_data", "pseudo_points_fit",
        "svgp_from_numpy", "likelihood_from_numpy", "nuts_data", "nuts_run", "smc_data",
        "smc_particles", "chain_state_from_numpy", "warmup_state_from_numpy", "derivative_data",
        "deconvolution_data", "nkn_data", "nkn_example", "differentiation_example",
        "quadrature_convolution_example", "nkn_layers_from_numpy", "fourier_basis_from_numpy",
        "big_n_sharded_example", "matrix_free_example", "matrix_free_data",
        "svgp_data_parallel_example", "svgp_dp_data", "rows_mesh", "chains_mesh", "data_mesh",
        "grid_mesh", "global_mesh", "initialize", "mauna_loa_example", "pseudo_points_example",
        "nuts_example", "smc_example", *[f"examples.{name}" for name in EXAMPLE_MODULES]])
def test_entry_points_default_to_cuda_and_raise_without_it(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    # a mesh that cannot have its card makes no gloo group in its place
    assert not dist.is_initialized()


TOOLS = ("nuts_bench", "nuts_pool", "smc_bench", "layout_study")


@pytest.mark.parametrize("name", TOOLS)
def test_the_tools_print_their_help_without_a_card(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"stheno_tpu_torch.{name}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0 and "usage" in capsys.readouterr().out


@pytest.mark.parametrize("name", TOOLS)
def test_the_tools_raise_without_a_card_by_default(name, monkeypatch):
    """With no arguments each tool runs on the card, so without one it
    raises (the pool, which runs on the host, asks for its files) and
    makes no process group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"stheno_tpu_torch.{name}")
    if name == "nuts_pool":
        with pytest.raises(SystemExit, match="usage"):
            mod.main([])
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])
    assert not dist.is_initialized()


def test_the_dry_run_raises_without_a_card(monkeypatch):
    from stheno_tpu_torch.multichip import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(1, device="cuda")
    assert not dist.is_initialized()


def test_rows_mesh_without_a_card_raises_and_makes_no_group(monkeypatch):
    """No fallback: a CUDA mesh on a machine without a card raises before
    any group exists; only `device_type="cpu"` asks for gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.rows_mesh()
    assert not dist.is_initialized()
    mesh = parallel.rows_mesh(device_type="cpu")
    try:
        assert dist.get_backend() == "gloo" and mesh.size() == 1
        # a gloo group in place does not stand in for the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.rows_mesh()
    finally:
        dist.destroy_process_group()


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    kern.reset_counters()
    with stt.config.chol_backend("blocked"), stt.config.bwd_params(block=256):
        step, theta = entry.flagship(512, torch.float32, device="cpu")
        val, grad = step(theta)
        x, y, xp, theta = entry.flagship_data(512, 64, torch.float32, device="cpu")
        m, v = entry.predict(theta, x, y, xp)
        data = entry.mauna_loa_data(320, 192, torch.float32, device="cpu")
        theta0, unflatten = params.init(entry.mauna_loa_spec(torch.float32, device="cpu"))
        ml_val, ml_grad = entry.mauna_loa_step(theta0, data)
        ms = entry.mauna_loa_predict(unflatten(theta0), data, xp)
        ys = stt.rand(torch.Generator().manual_seed(0),
                      entry.build_gp(unflatten(theta0))(entry.mauna_loa_query(xp)), 2)
        pp = entry.pseudo_points_data(2048, 256, torch.float32, device="cpu", half_width=192.0)
        pp_theta, pp_unflatten = params.init(entry.pseudo_points_spec(pp[2]))
        pp_val, pp_grad = entry.pseudo_points_step(pp_theta, pp)
        pp_ms = entry.pseudo_points_predict(pp_unflatten(pp_theta), pp, xp)
        with stt.config.logpdf_fused("on"):
            fused_val, _ = step(theta)
        with stt.config.gemm_precision("high"):  # the split's plain version
            high_val, _ = step(theta)
    assert np.isfinite(val.item()) and all(np.isfinite(g.item()) for g in grad.values())
    assert np.isfinite(high_val.item())
    assert m.shape == v.shape == (64,)
    assert np.isfinite(ml_val.item()) and bool(torch.isfinite(ml_grad).all())
    assert ms.mean.shape == (192,) and ys.shape == (192, 2)
    assert np.isfinite(pp_val.item()) and bool(torch.isfinite(pp_grad).all())
    assert pp_ms.mean.shape == (128,) and np.isfinite(fused_val.item())
    assert {k: c.total for k, c in kern.COUNTERS.items()} == {
        "kernelmatrix": 0, "kernelmatrix_batched": 0, "kernelmatrix_vjp": 0, "chol_block": 0,
        "tri_inv_block": 0, "km_se_d1": 0, "tf32_split": 0}


def test_derivative_pathwise_deconvolution_and_nkn_on_cpu_count_no_launch():
    """The new paths at a small size on CPU tensors, on the blocked route:
    finite results, and no launch counted."""
    kern.reset_counters()
    with stt.config.chol_backend("blocked"), stt.config.bwd_params(block=256):
        d = entry.derivative_data(512, 32, torch.float32, device="cpu")
        d_val, d_grad = entry.derivative_step(d[4], d[:3])
        d_ms = entry.derivative_predict(d[4], d[:4])
        x, y, xp, theta = entry.flagship_data(512, 32, torch.float32, device="cpu")
        draws = entry.pathwise_samples(theta, x, y, xp, num_samples=4, num_features=64)
        c = entry.deconvolution_data(512, 32, 128, torch.float32, device="cpu")
        c_val, c_grad = entry.deconvolution_step(c[3], c[:3])
        c_ms = entry.deconvolution_predict(c[3], c[:3])
        nx, ny, n_train, period = entry.nkn_data(256, torch.float32, device="cpu")
        spec = entry.nkn_spec(nx[:n_train], period)
        n_val, n_grad = entry.nkn_step(params.init(spec)[0], nx, ny, spec)
    for val, grad in ((d_val, d_grad), (c_val, c_grad)):
        assert np.isfinite(val.item()) and all(np.isfinite(g.item()) for g in grad.values())
    assert np.isfinite(n_val.item()) and bool(torch.isfinite(n_grad).all())
    assert d_ms.mean.shape == (96,) and c_ms.mean.shape == (64,)
    assert draws["f1"].shape == (4, 32)
    torch.testing.assert_close(draws["f1"] + draws["f2"], draws["f3"])
    assert all(c.total == 0 for c in kern.COUNTERS.values())


def test_build_raises_with_the_reason_when_nvcc_is_missing(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("kernelmatrix")


def test_build_output_is_git_ignored():
    assert _build.BUILD_DIR.is_relative_to(REPO / "build")
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok": true' not in out.stdout

"""The benchmark's plain reference of the two-output Mauna Loa programme
(`benchmark/reference/mauna_loa16k.py`, loaded by path) against the port's
`entry.mauna_loa_step` at 96 + 32 points on the CPU: in float64 both are one
formula evaluated twice; in float32 the port is held to float64 leaf by leaf
as tightly as float32 allows, and its TF32 route falls outside; at 384 + 128
points the two constant scales hold in float32 too.  The file imports
neither JAX nor the JAX package."""

import ast
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from stheno_tpu_torch import config, entry
from stheno_tpu_torch import params as P

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "mauna_loa16k.json").read_text())
#: The CPU size of the cell's rehearsal file.
SMALL = {"n_co2": 96, "n_T": 32}


def _load(kind, name):
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", BENCH / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("reference", "mauna_loa16k")


def _problem(seed, dtype):
    """The example's data at 96 + 32 points (`entry.mauna_loa_data`), θ₀ of
    the port's spec moved by 0.2·ε from `seed` (θ₀ itself at seed 0), and
    the configuration at that size."""
    cfg = {**CONFIG, **SMALL}
    x_co2, y_co2, x_T, y_T = entry.mauna_loa_data(SMALL["n_co2"], SMALL["n_T"], dtype, "cpu")
    data = {"x_co2": x_co2, "y_co2": y_co2, "x_T": x_T, "y_T": y_T}
    theta0, _ = P.init(entry.mauna_loa_spec(dtype, "cpu"))
    if seed:
        eps = torch.randn(theta0.shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
        theta0 = theta0 + (0.2 * eps).to(dtype)
    return cfg, data, theta0


def _port(data, theta):
    obs = tuple(data[k] for k in ("x_co2", "y_co2", "x_T", "y_T"))
    with config.chol_backend("blocked"):
        return entry.mauna_loa_step(theta, obs)


@pytest.mark.parametrize("seed", [0, 1])
def test_float64_reference_is_the_ports_formula(seed):
    """Two float64 evaluations of one formula: value and each of the 12
    gradient leaves to 1e-9 of themselves (they agree to about 1e-12; the
    gradient's terms cancel by up to three orders, hence the margin)."""
    cfg, data, theta = _problem(seed, torch.float64)
    value, grad = _port(data, theta)
    ref_value, ref_grad = REF.value_and_grad(cfg, data, theta)
    assert float(value) == pytest.approx(ref_value, rel=1e-9)
    assert len(ref_grad) == 12
    for (name, _), g, r in zip(REF.leaves(cfg), grad.tolist(), ref_grad.tolist()):
        assert g == pytest.approx(r, rel=1e-9), name


#: float32 against float64 at 96 + 32 points, the port's blocked route,
#: seeds 0-7: the value's relative gap reads at most 1.5e-5 (f32's unit
#: roundoff 6e-8 grown by the covariance's condition number), so 1e-4;
#: each gradient leaf's gap over the larger of its own size and the median
#: leaf's (`benchmark/harness/compare.py`'s scale, so a leaf at 1 % of the
#: median is held to its own size) at most 1.2e-4, so 2.5e-4.  Outside: the
#: TF32 route's gradient (8.5e-4 to 8.5e-3 over the same seeds: TF32 rounds
#: each product's operands to 2^-11), and the constant scales summed over
#: the float32 cotangent of the whole covariance, as the port did before
#: `graph.split_constants` (4.0e-4 at seed 1, on `temp.s_mean`).
F32_VALUE, F32_LEAF = 1e-4, 2.5e-4


def _leaf_gaps(grad, ref_grad):
    """|g − r| of each leaf over max(|r|, median |r|)."""
    med = ref_grad.abs().median()
    return (grad.double() - ref_grad).abs() / torch.maximum(ref_grad.abs(), med)


def _f32_gaps(seed):
    cfg, data, theta0 = _problem(seed, torch.float32)
    value, grad = _port(data, theta0)
    ref_value, ref_grad = REF.value_and_grad(cfg, data, theta0)
    return abs(float(value) - ref_value) / abs(ref_value), float(_leaf_gaps(grad, ref_grad).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float32_port_against_the_float64_reference(seed):
    value_gap, grad_gap = _f32_gaps(seed)
    assert value_gap <= F32_VALUE and grad_gap <= F32_LEAF, (value_gap, grad_gap)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_tf32_route_fails_the_float32_tolerances(seed):
    with config.gemm_precision("default"):
        value_gap, grad_gap = _f32_gaps(seed)
    assert value_gap > F32_VALUE or grad_gap > F32_LEAF, (value_gap, grad_gap)


#: The two constant scales in float32 at 384 + 128 points, each against its
#: own float64 value: 1e-5 through `graph.split_constants`; 1.8 %, 21 % and
#: 10 % on `temp.s_mean` at seeds 0-2 where they were summed over the
#: float32 cotangent of the whole covariance, whose entries (up to 1e3 here)
#: cancel to a sum below 1.
F32_CONSTANT = 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float32_constant_scales_hold_at_512_points(seed, monkeypatch):
    monkeypatch.setitem(SMALL, "n_co2", 384)
    monkeypatch.setitem(SMALL, "n_T", 128)
    cfg, data, theta0 = _problem(seed, torch.float32)
    _, grad = _port(data, theta0)
    _, ref_grad = REF.value_and_grad(cfg, data, theta0)
    names = [name for name, _ in REF.leaves(cfg)]
    for name in ("co2.s_mean", "temp.s_mean"):
        k = names.index(name)
        assert abs(float(grad[k]) - float(ref_grad[k])) <= F32_CONSTANT * abs(float(ref_grad[k])), name


def test_leaves_follow_the_ports_flat_theta():
    """Moving the k-th entry of `params.init`'s flat θ moves the parameter
    the reference names k-th, and no other."""
    spec = entry.mauna_loa_spec(torch.float64, "cpu")
    theta0, unflatten = P.init(spec)

    def flat(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from flat(tree[k], f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", tree[k]

    base = dict(flat(unflatten(theta0)))
    names = [name for name, size in REF.leaves(CONFIG)]
    assert len(names) == len(theta0) == 12 and "co2.freq" not in names
    for k, name in enumerate(names):
        moved = theta0.clone()
        moved[k] += 0.5
        changed = [n for n, v in flat(unflatten(moved)) if not torch.equal(v, base[n])]
        assert changed == [name]


def test_reference_imports_nothing_of_either_package():
    tree = ast.parse((BENCH / "reference" / "mauna_loa16k.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert roots.isdisjoint({"jax", "jaxlib", "stheno_tpu", "stheno_tpu_torch", "harness"}), roots
    assert roots <= {"__future__", "contextlib", "math", "torch"}

"""The plain references against closed forms at small N: the dense
multivariate normal for the flagship's value and the pseudo-point bound,
central differences for their gradients, the dense posterior for the
marginals (numpy, float64)."""

import math

import numpy as np
import pytest
import torch
from harness.registry import Registry, load_module

from conftest import BENCH, ROOT

FLAGSHIP = load_module(BENCH / "reference" / "flagship16k.py", "reference")
VFE = load_module(BENCH / "reference" / "vfe131k.py", "reference")


def _mvn_neg_logpdf(K, y):
    sign, logdet = np.linalg.slogdet(K)
    assert sign > 0
    return 0.5 * (y @ np.linalg.solve(K, y) + logdet + len(y) * math.log(2 * math.pi))


def _flagship_dense(x, th):
    d = x[:, None] - x[None, :]
    k1 = th["v1"] * np.exp(-0.5 * (d / th["l1"]) ** 2)
    s = math.sqrt(3) * np.abs(d) / th["l2"]
    return k1, k1 + (1 + s) * np.exp(-s) + th["noise"] * np.eye(len(x))


def _flagship_data(n, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-5, 5, n))
    y = np.sin(x) + 0.2 * np.cos(7 * x) + math.sqrt(0.1) * rng.normal(size=n)
    return x, y


def _central(f, raw, h=1e-6):
    out = np.zeros_like(raw)
    for i in range(len(raw)):
        e = np.zeros_like(raw)
        e[i] = h
        out[i] = (f(raw + e) - f(raw - e)) / (2 * h)
    return out


@pytest.mark.parametrize("n", [3, 40])
def test_flagship_value_and_grad(n):
    x, y = _flagship_data(n, seed=n)
    names = [name for name, _ in FLAGSHIP.LEAVES]
    raw = np.log([0.9, 0.6, 0.15, 1.3])  # l1, l2, noise, v1

    def dense(r):
        return _mvn_neg_logpdf(_flagship_dense(x, dict(zip(names, np.exp(r))))[1], y)

    data = {"x": torch.tensor(x), "y": torch.tensor(y)}
    value, grad = FLAGSHIP.value_and_grad({}, data, torch.tensor(raw))
    assert value == pytest.approx(dense(raw), rel=1e-12, abs=1e-12)
    np.testing.assert_allclose(grad.numpy(), _central(dense, raw), rtol=1e-6, atol=1e-7)


def test_flagship_marginals():
    x, y = _flagship_data(50, seed=1)
    th = dict(v1=1.5, l1=1.0, l2=0.5, noise=0.1)
    xq = np.linspace(-6, 6, 17)
    _, K = _flagship_dense(x, th)
    kq = th["v1"] * np.exp(-0.5 * ((x[:, None] - xq[None, :]) / th["l1"]) ** 2)
    mean = kq.T @ np.linalg.solve(K, y)
    var = th["v1"] - np.einsum("iq,iq->q", kq, np.linalg.solve(K, kq)) + 1e-6
    data = {"x": torch.tensor(x), "y": torch.tensor(y)}
    ((m, v, prior),) = FLAGSHIP.marginals({"query_noise": 1e-6}, data, th, [torch.tensor(xq)])
    np.testing.assert_allclose(m.numpy(), mean, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), var, rtol=1e-9, atol=1e-12)
    assert float(prior[0]) == pytest.approx(1.5 + 1e-6)


def _vfe_dense(x, y, z, th, eps):
    def k1(a, b):
        return th["v1"] * np.exp(-0.5 * ((a[:, None] - b[None, :]) / th["l1"]) ** 2)

    def k2(a, b):
        s = math.sqrt(5) * np.abs(a[:, None] - b[None, :]) / th["l2"]
        return th["v2"] * (1 + s + s * s / 3) * np.exp(-s)

    m = len(z)
    Kuu = np.zeros((2 * m, 2 * m))
    Kuu[:m, :m], Kuu[m:, m:] = k1(z, z), k2(z, z)
    Kuu += eps * np.eye(2 * m)
    Kuf = np.concatenate([k1(z, x), k2(z, x)])
    Q = Kuf.T @ np.linalg.solve(Kuu, Kuf)
    n = len(x)
    elbo = -_mvn_neg_logpdf(Q + th["noise"] * np.eye(n), y) \
        - (n * (th["v1"] + th["v2"]) - np.trace(Q)) / (2 * th["noise"])
    return -elbo


def test_vfe_value_and_grad():
    rng = np.random.default_rng(5)
    n, m = 60, 5
    x = np.sort(rng.uniform(-6, 6, n))
    y = np.sin(x / 2) + 0.3 * np.sin(2.5 * x + 1) + math.sqrt(0.05) * rng.normal(size=n)
    z = np.linspace(-6, 6, m) + 0.1 * rng.normal(size=m)
    cfg = {"m_per_latent": m, "inducing_noise": 1e-6}
    raw = np.concatenate([np.log([0.9, 1.2, 0.2, 0.8, 0.7]), z])  # l1, l2, noise, v1, v2, z

    def dense(r):
        th = dict(zip(("l1", "l2", "noise", "v1", "v2"), np.exp(r[:5])))
        return _vfe_dense(x, y, r[5:], th, cfg["inducing_noise"])

    data = {"x": torch.tensor(x), "y": torch.tensor(y)}
    value, grad = VFE.value_and_grad(cfg, data, torch.tensor(raw))
    assert value == pytest.approx(dense(raw), rel=1e-10)
    np.testing.assert_allclose(grad.numpy(), _central(dense, raw, h=1e-6), rtol=2e-5, atol=2e-6)


def test_vfe_blocks_agree():
    """The blocked sums give the bound whatever the block."""
    rng = np.random.default_rng(2)
    n, m = 500, 4
    x = torch.tensor(np.sort(rng.uniform(-4, 4, n)))
    data = {"x": x, "y": torch.sin(x)}
    cfg = {"m_per_latent": m, "inducing_noise": 1e-6}
    raw = torch.cat([torch.log(torch.tensor([1.0, 1.0, 0.2, 0.8, 0.8], dtype=torch.float64)),
                     torch.linspace(-4, 4, m, dtype=torch.float64)])
    whole = VFE.value_and_grad(cfg, data, raw)
    saved = VFE.COLS
    try:
        VFE.COLS = 64
        blocked = VFE.value_and_grad(cfg, data, raw)
    finally:
        VFE.COLS = saved
    assert blocked[0] == pytest.approx(whole[0], rel=1e-12)
    np.testing.assert_allclose(blocked[1].numpy(), whole[1].numpy(), rtol=1e-9, atol=1e-12)


def test_references_are_plain():
    """Every configuration's reference imports nothing of the program, nor JAX."""
    for name in (c["name"] for c in Registry(ROOT).spec["configs"]):
        src = (BENCH / "reference" / f"{name}.py").read_text()
        for word in ("stheno_tpu", "jax", "harness"):
            assert f"import {word}" not in src and f"from {word}" not in src

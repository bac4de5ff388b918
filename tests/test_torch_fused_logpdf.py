"""The fused MvNormal logpdf (`ops.chol._MvnLogpdfFused`, whose backward is
the closed form ½(ααᵀ − K⁻¹)) against the JAX package's
`_mvn_logpdf_fused` and against the port's own unfused route, and its
routing under `config.logpdf_fused`.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: f64 value and gradients to rtol 1e-10 against the reference
(the gradients against their largest entry), and to 1e-12 against the
unfused route, as the reference's own test (`tests/test_ops.py:363`) holds
it; f32 to 1e-4 (value) and 5e-3 of the largest entry (gradients)."""

from contextlib import ExitStack

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu
import stheno_tpu_torch as stt
from stheno_tpu.ops import chol as JC
from stheno_tpu_torch import entry
from stheno_tpu_torch.cuda.chol_block import tri_inv_block
from stheno_tpu_torch.ops import chol as TC
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _psd(rng, n):
    G = rng.normal(size=(n, n))
    return G @ G.T / n + 0.5 * np.eye(n)


def _inputs(n, seed=21):
    rng = np.random.default_rng(seed)
    return _psd(rng, n), rng.normal(size=n), rng.normal(size=n)


def _torch_value_and_grads(fn, K, y, m, dtype):
    args = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (K, y, m)]
    val = fn(*args)
    return val.item(), [g.numpy() for g in torch.autograd.grad(val, args)]


def _fused_torch(K, y, m):
    return TC._MvnLogpdfFused.apply(TC.symmetrize(K), y - m)


def _fused_jax(K, y, m):
    return JC._mvn_logpdf_fused(JC.symmetrize(K), y - m)


def _blocked(package):
    stack = ExitStack()
    stack.enter_context(package.config.chol_backend("blocked"))
    stack.enter_context(package.config.bwd_params(block=256))
    return stack


@pytest.mark.parametrize("route", ["library", "blocked"])
def test_fused_matches_reference_f64(route):
    """Value and the gradients in (K, y, m) against the reference's fused
    logpdf, on the library factor (n = 300) and on the blocked one
    (n = 768: three panels of 256)."""
    n = 300 if route == "library" else 768
    K, y, m = _inputs(n)
    with _blocked(stheno_tpu) if route == "blocked" else ExitStack():
        jv, jg = jax.jit(jax.value_and_grad(_fused_jax, argnums=(0, 1, 2)))(
            *(jnp.asarray(a) for a in (K, y, m)))
    with _blocked(stt) if route == "blocked" else ExitStack():
        v, g = _torch_value_and_grads(_fused_torch, K, y, m, torch.float64)
    np.testing.assert_allclose(v, float(jv), rtol=1e-10)
    for a, b in zip(g, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * np.abs(b).max())


def test_fused_matches_unfused():
    """The closed-form gradient equals autograd through the factor (the
    reference's `test_fused_logpdf_matches_unfused`, on the port), f64."""
    K, y, m = _inputs(256, seed=5)

    def unfused(K, y, m):
        return TC.mvn_logpdf_chol(y, m, TC.cholesky_psd(K))

    v0, g0 = _torch_value_and_grads(unfused, K, y, m, torch.float64)
    v1, g1 = _torch_value_and_grads(_fused_torch, K, y, m, torch.float64)
    np.testing.assert_allclose(v1, v0, rtol=1e-12)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(b).max())


def test_fused_backward_inverts_the_base_blocks_f32():
    """On the blocked route in f32 the backward's K⁻¹ goes through the
    base-case inverse (kernel 3's wrapper; its plain version on the CPU),
    and value and gradients agree with the reference's f32 fused logpdf."""
    K, y, m = _inputs(512, seed=8)
    calls = []

    def spy(L):
        calls.append(tuple(L.shape))
        return tri_inv_block(L)

    with _blocked(stheno_tpu):
        jv, jg = jax.jit(jax.value_and_grad(_fused_jax, argnums=(0, 1, 2)))(
            *(jnp.asarray(a, dtype=jnp.float32) for a in (K, y, m)))
    with _blocked(stt):
        args = [torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in (K, y, m)]
        val = _fused_torch(*args)
        with stt.config.scoped(base_tri_inv=spy):
            grads = torch.autograd.grad(val, args)
    assert (2, 256, 256) in calls  # one batched call on the two base blocks of L
    np.testing.assert_allclose(val.item(), float(jv), rtol=1e-4)
    for a, b in zip(grads, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=5e-3 * np.abs(b).max())


def test_routing_follows_the_scoped_mode(monkeypatch):
    """'off' never fuses, 'on' fuses a single vector, 'auto' fuses where
    the blocked route applies, a 2-D y never fuses, and an unknown mode
    raises."""
    calls = []
    original = TC._MvnLogpdfFused.apply

    def counting(*args):
        calls.append(1)
        return original(*args)

    monkeypatch.setattr(TC._MvnLogpdfFused, "apply", counting)
    K, y, m = (torch.as_tensor(a) for a in _inputs(64))
    Y = torch.stack([y, -y], dim=1)
    ref = TC.mvn_logpdf_chol(y, m, TC.cholesky_psd(K)).item()
    cases = [("off", "torch", y, 0), ("on", "torch", y, 1), ("auto", "torch", y, 0),
             ("auto", "blocked", y, 1), ("on", "torch", Y, 0)]
    for mode, backend, yy, fused in cases:
        calls.clear()
        with stt.config.logpdf_fused(mode), stt.config.chol_backend(backend):
            out = TC.mvn_logpdf_psd(yy, m, K)
        assert len(calls) == fused, (mode, backend, yy.dim())
        if yy.dim() == 1:
            np.testing.assert_allclose(out.item(), ref, rtol=1e-12)
    assert TC.LOGPDF_FUSED == "off"
    with pytest.raises(ValueError, match="fused-logpdf mode"):
        stt.config.logpdf_fused("sometimes")


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_flagship_logpdf_fused_matches_reference(dtype):
    """The flagship's −logpdf and gradient at n = 512 through `logpdf` with
    the fused route forced on both sides (blocked, backward panels of 256)."""
    from __graft_entry__ import _flagship

    jdt, tdt = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}[dtype]
    with _blocked(stheno_tpu), stheno_tpu.config.scoped(logpdf_fused="on"):
        jstep, jtheta = _flagship(jdt, 512)
        jval, jgrad = jax.jit(jstep)(jtheta)
    with _blocked(stt), stt.config.logpdf_fused("on"):
        step, theta = entry.flagship(512, tdt, device="cpu")
        val, grad = step(theta)
    rtol = 1e-10 if dtype == "f64" else 1e-4
    np.testing.assert_allclose(val.item(), float(jval), rtol=rtol)
    for k in grad:
        np.testing.assert_allclose(grad[k].item(), float(jgrad[k]), rtol=rtol if dtype == "f64" else 5e-3,
                                   err_msg=k)


def test_fused_route_reaches_the_finite_gp_surface():
    """`logpdf` of a FiniteGP under 'on' equals the default route in value
    and gradient (f64)."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(np.sort(rng.uniform(-3, 3, 90)))
    y = torch.sin(x)

    def value_and_grad():
        v = torch.tensor(1.2, dtype=torch.float64, requires_grad=True)
        with stt.GPC():
            f = stt.GP(v * stt.with_lengthscale(stt.Matern52Kernel(), 0.8))
        val = stt.logpdf(f(x, 0.05), y)
        return val.item(), torch.autograd.grad(val, v)[0].item()

    base = value_and_grad()
    with stt.config.logpdf_fused("on"):
        fused = value_and_grad()
    np.testing.assert_allclose(fused, base, rtol=1e-11)

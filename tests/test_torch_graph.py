"""The affine ops of the port's process graph against `stheno_tpu.graph`, in
f64 on the CPU: constant and function shifts (`AddConstGP`, `AddFnGP` with a
`ParamFn`), function scalings (`ScaledFnGP`), wrapped leaves (`WrappedGP`),
every input warp, `additive_gp` and `CrossGP`.

Each new process type goes through the port's `check_process_interface`,
and its mean, cov, var, cov2, var2 and cross-covariances with an atomic GP
go through both packages on the same numpy-seeded inputs (rtol 1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as st
import stheno_tpu_torch as stt
from stheno_tpu_torch.utils.testing import check_process_interface
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _ops(name, m, xp):
    """The programme of case `name` in package `m` with array module `xp`:
    returns (h, f): the process under test and an atomic of the same
    programme on h's input space (for the warps into 1-D from 2-D inputs,
    an atomic k on the 2-D inputs that h adds in)."""
    a = xp.asarray(0.7) if xp is jnp else torch.tensor(0.7, dtype=torch.float64)
    with m.GPC() as gpc:
        k = m.GP(m.with_lengthscale(m.SEKernel(), 1.3))
        f = m.GP(m.SEKernel())
        g = m.GP(2.0 * m.with_lengthscale(m.Matern52Kernel(), 0.5))
        if name == "add_const":
            h = 1.5 + (f + g)
        elif name == "rsub_const":
            h = 2.0 - f
        elif name == "add_fn":
            h = (f + g) + m.ParamFn(lambda p, x: p["a"] * xp.sin(x), {"a": a})
        elif name == "scaled_fn":
            h = m.ParamFn(lambda p, x: p["a"] * xp.tanh(x) + 1.2, {"a": a}) * (f + g)
        elif name == "scaled_fn_plain":
            h = (lambda x: xp.cos(x)) * g
        elif name == "wrapped":
            with m.GPC():
                other = m.GP(m.Matern32Kernel()) + m.GP(0.5 * m.SEKernel())
            h = m.atomic(other, gpc) + f
        elif name == "stretch":
            h = m.stretch(f + g, 2.0)
        elif name == "stretch_ard":
            h = m.stretch(f, xp.asarray([0.5, 2.0]) if xp is jnp
                          else torch.tensor([0.5, 2.0], dtype=torch.float64))
        elif name == "select":
            return m.select(f, 1) + g @ m.Select([0]) + k, k
        elif name == "periodic":
            h = m.periodic(g, 0.5) + f
        elif name == "shift":
            h = m.shift(f + g, 0.3)
        elif name == "fn_warp":
            h = m.compose(f, lambda x: x**2) + g
        elif name == "matmul_stretch":
            h = f @ m.Stretch(1.7)
        elif name == "additive":
            return m.additive_gp([f, g], [1, 0]) + k, k
        else:
            raise KeyError(name)
    return h, f


def _dim(name):
    return 2 if name in ("select", "additive", "stretch_ard") else 1


CASES = ["add_const", "rsub_const", "add_fn", "scaled_fn", "scaled_fn_plain", "wrapped", "stretch",
         "stretch_ard", "select", "periodic", "shift", "fn_warp", "matmul_stretch", "additive"]


def _x(seed, n, dim):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, dim) if dim > 1 else (n,))


def _stats(m, h, f, x, x2, x3):
    """Every statistic the case is held to, by name."""
    return {
        "mean": h.mean(x), "cov": h.cov(x), "var": h.var(x), "cov2": h.cov2(x, x2),
        "var2": h.var2(x, x3),
        "cross_cov_hf": m.cross_cov(h, f, x, x2), "cross_cov_fh": m.cross_cov(f, h, x2, x),
        "cross_var_hf": m.cross_var(h, f, x, x3), "cross_var_fh": m.cross_var(f, h, x3, x),
    }


def _compare(jstats, tstats):
    for k, want in jstats.items():
        got = tstats[k]
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-13, err_msg=k)


@pytest.mark.parametrize("name", CASES)
def test_op_matches_reference(name):
    dim = _dim(name)
    x, x2, x3 = _x(0, 13, dim), _x(1, 9, dim), _x(2, 13, dim)
    jh, jf = _ops(name, st, jnp)
    th, tf = _ops(name, stt, torch)
    _compare(_stats(st, jh, jf, *(jnp.asarray(v) for v in (x, x2, x3))),
             _stats(stt, th, tf, *(torch.as_tensor(v) for v in (x, x2, x3))))


@pytest.mark.parametrize("name", CASES)
def test_op_passes_the_conformance_checks(name):
    dim = _dim(name)
    th, tf = _ops(name, stt, torch)
    check_process_interface(th, *(torch.as_tensor(_x(s, n, dim)) for s, n in ((3, 11), (4, 11), (5, 7))),
                            f2=tf)


def test_paramfn_gradients_match_reference():
    """d logpdf / d a flows through a function-valued shift and scaling."""
    x = _x(6, 17, 1)
    y = np.random.default_rng(7).normal(size=17)

    def jloss(a):
        with st.GPC():
            f = st.GP(st.SEKernel())
            h = st.ParamFn(lambda p, z: 1.0 + p * jnp.tanh(z), a) * f + st.ParamFn(
                lambda p, z: p * jnp.sin(z), a)
        return st.logpdf(h(jnp.asarray(x), 0.1), jnp.asarray(y))

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(0.6))
    a = torch.tensor(0.6, dtype=torch.float64, requires_grad=True)
    with stt.GPC():
        f = stt.GP(stt.SEKernel())
        h = stt.ParamFn(lambda p, z: 1.0 + p * torch.tanh(z), a) * f + stt.ParamFn(
            lambda p, z: p * torch.sin(z), a)
    val = stt.logpdf(h(torch.as_tensor(x), 0.1), torch.as_tensor(y))
    (g,) = torch.autograd.grad(val, a)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-12)
    np.testing.assert_allclose(g.item(), float(jgrad), rtol=1e-10)


def _cross_programme(m):
    with m.GPC():
        f = m.GP(m.SEKernel())
        g = m.GP(m.with_lengthscale(m.Matern32Kernel(), 0.7))
        h = 0.5 * f + g
        c = m.cross([f, h])
        c2 = m.cross([h, g, f])
    return f, g, h, c, c2


def test_cross_matches_reference():
    rng = np.random.default_rng(8)
    xa, xb, xc = rng.normal(size=5), rng.normal(size=7), rng.normal(size=4)
    x12, x_flat = rng.normal(size=12), rng.normal(size=16)
    out = []
    for m, arr in ((st, jnp.asarray), (stt, torch.as_tensor)):
        f, g, h, c, c2 = _cross_programme(m)
        B = m.BlockData(arr(xa), arr(xb))          # c's inputs: 12 points
        B2 = m.BlockData(arr(xb), arr(xc), arr(xa))  # c2's inputs: 16 points
        out.append({
            "mean": c.mean(B), "cov": c.cov(B), "var": c.var(B), "cov2": c.cov2(B, B),
            "var2": c.var2(B, B),
            # against an atomic: the rows, the columns, and the O(N) paired diagonal
            "cc_l": m.cross_cov(c, g, B, arr(xc)), "cc_r": m.cross_cov(g, c, arr(xc), B),
            "cv_l": m.cross_var(c, g, B, arr(x12)), "cv_r": m.cross_var(g, c, arr(x12), B),
            # two stacks: dense blocks, and the dense diagonal
            "cc_cc": m.cross_cov(c2, c, B2, B), "cc_cc_t": m.cross_cov(c, c2, B, B2),
            "cv_cc": m.cross_var(c2, c, B2, m.BlockData(arr(x_flat[:8]), arr(x_flat[8:]))),
        })
    _compare(*out)


def test_cross_conformance_and_bad_inputs():
    f, g, h, c, _ = _cross_programme(stt)
    rng = np.random.default_rng(9)
    B0, B1, B2 = (stt.BlockData(torch.as_tensor(rng.normal(size=n)), torch.as_tensor(rng.normal(size=k)))
                  for n, k in ((4, 6), (4, 6), (3, 2)))
    check_process_interface(c, B0, B1, B2)
    with pytest.raises(TypeError):
        c.cov(torch.zeros(3))
    with pytest.raises(ValueError):
        c.mean(stt.BlockData(torch.zeros(3)))

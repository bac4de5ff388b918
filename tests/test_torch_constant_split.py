"""Constant leaves taken out of a covariance (`graph.split_constants`) and
the logpdf that reads them as a part of rank r
(`ops/chol.mvn_logpdf_lowrank`), in float64 on the CPU: the split is exact,
it leaves whole what it cannot take out, and the logpdf through it gives
the dense route's value and gradient."""

import pytest
import torch

import stheno_tpu_torch as stt
from stheno_tpu_torch import entry, finite_gp
from stheno_tpu_torch import params as P
from stheno_tpu_torch.graph import split_constants
from stheno_tpu_torch.inputs import BlockData, GPPPInput
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

F64 = torch.float64


def _mauna_loa(n_co2=24, n_T=8):
    x_co2, y_co2, x_T, y_T = entry.mauna_loa_data(n_co2, n_T, F64, "cpu")
    theta0, unflatten = P.init(entry.mauna_loa_spec(F64, "cpu"))
    theta = theta0 + 0.1 * torch.arange(len(theta0), dtype=F64)
    return unflatten(theta), (x_co2, y_co2, x_T, y_T)


def test_split_takes_out_each_outputs_constant():
    t, data = _mauna_loa()
    x, _ = entry.mauna_loa_observations(data)
    f, v = entry.build_gp(t).extract(x)
    rest, U, a = split_constants(f, v)
    assert U.shape == (32, 2) and U[:24, 0].eq(1).all() and U[24:, 1].eq(1).all()
    assert U[24:, 0].eq(0).all() and U[:24, 1].eq(0).all()
    assert torch.allclose(a.abs(), torch.stack([t["co2"]["s_mean"], t["temp"]["s_mean"]]), rtol=1e-15)
    full = f.cov(v)
    assert torch.allclose(rest.cov(v) + (U * a**2) @ U.T, full, rtol=1e-14, atol=1e-14)


def _programme(case):
    x = torch.linspace(-2.0, 2.0, 12, dtype=F64)
    with stt.GPC():
        c = stt.GP(stt.ConstantKernel(2.0))
        g = stt.GP(stt.SEKernel())
        h = stt.GP(stt.Matern52Kernel())
        if case == "shared":  # one constant under two outputs
            fs = (0.5 * c + g, c + h)
        elif case == "constant_output":  # an output that is only a constant
            fs = (0.5 * c, g)
        elif case == "warped":  # a constant seen through a warp is left alone
            fs = (stt.stretch(c, 2.0) + g, h)
        f = stt.cross(fs)
    return f, BlockData(x[:7], x[7:])


@pytest.mark.parametrize("case", ["shared", "constant_output", "warped"])
def test_split_leaves_whole_what_it_cannot_take_out(case):
    f, v = _programme(case)
    assert split_constants(f, v) is None


def _logpdf_and_grad(build, dense, monkeypatch):
    if dense:
        monkeypatch.setattr(finite_gp, "_constant_split", lambda fx: None)
    theta, fx_of, y = build()
    val = stt.logpdf(fx_of(theta), y).sum()
    (grad,) = torch.autograd.grad(val, theta)
    monkeypatch.undo()
    return val.detach(), grad


def _single(cols):
    """A one-output programme with a trained constant scale, y (N,) or (N, 2)."""
    x = torch.linspace(-3.0, 3.0, 20, dtype=F64)
    gen = torch.Generator().manual_seed(5)
    y = torch.randn((20, cols) if cols else (20,), generator=gen, dtype=F64)

    def fx_of(th):
        with stt.GPC():
            f = th[0] * stt.GP(stt.ConstantKernel(1.5)) + stt.GP(th[1] * stt.SEKernel())
        return f(x, 0.1)

    return torch.tensor([0.8, 1.3], dtype=F64, requires_grad=True), fx_of, y


def _joint():
    t, data = _mauna_loa()
    theta0, unflatten = P.init(entry.mauna_loa_spec(F64, "cpu"))
    theta = (theta0 + 0.05).requires_grad_(True)
    x, y = entry.mauna_loa_observations(data)

    def fx_of(th):
        tt = unflatten(th)
        return entry.build_gp(tt)(x, entry.obs_noise(tt, len(data[0]), len(data[2])))

    return theta, fx_of, y


@pytest.mark.parametrize("build", [lambda: _single(0), lambda: _single(2), _joint],
                         ids=["one_output", "two_columns", "mauna_loa"])
def test_logpdf_through_the_split_is_the_dense_logpdf(build, monkeypatch):
    val, grad = _logpdf_and_grad(build, False, monkeypatch)
    dense_val, dense_grad = _logpdf_and_grad(build, True, monkeypatch)
    assert float(val) == pytest.approx(float(dense_val), rel=1e-12)
    assert torch.allclose(grad, dense_grad, rtol=1e-9, atol=1e-12)

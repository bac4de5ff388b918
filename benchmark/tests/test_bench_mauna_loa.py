"""The two-output Mauna Loa configuration's plain reference
(`reference/mauna_loa16k.py`) against a dense multivariate normal built
here from the model's equations in numpy, its gradient against central
differences, and the two readers of the spans it added
(`graph_reverse_ms.train`, `cross_ms.train`) against synthetic records."""

import math

import numpy as np
import pytest
import scipy.stats
import torch
from harness import program_spans as ps
from harness.registry import Registry

from conftest import ROOT
from test_bench_program_spans import MS, Calls, traced

REG = Registry(ROOT)
REF = REG.reference("mauna_loa16k")
SMALL = {"n_co2": 40, "n_T": 24}


def _problem(seed):
    cfg = {**REG.config("mauna_loa16k"), **SMALL}
    gen = torch.Generator().manual_seed(seed)
    data = REG.programme(cfg["programme"]).make_data({**cfg, "dtype": "float64"}, gen, "cpu")
    raw = torch.tensor([math.log(v) for v in (5.0, 0.3, 1.0, 0.1, 0.3, 0.3, 0.5, 1.0, 0.1, 1.0, 1.0, 0.1)],
                       dtype=torch.float64)
    raw += 0.3 * torch.randn(raw.shape, generator=gen, dtype=torch.float64)
    return cfg, data, raw


def _numpy_covariance(cfg, data, raw):
    """The joint covariance from the model as written: each process's
    kernel on its own inputs, the periodic one on [cos 2πft, sin 2πft]."""
    th = dict(zip((n for n, _ in REF.leaves(cfg)), np.exp(raw.numpy())))
    f = cfg["theta"]["co2"]["freq"]
    c, t = data["x_co2"].numpy(), data["x_T"].numpy()

    def se(a, b, scale):
        return np.exp(-0.5 * (scale * (a[:, None] - b[None, :])) ** 2)

    def periodic(a, b):
        ea = np.stack([np.cos(2 * np.pi * f * a), np.sin(2 * np.pi * f * a)], 1)
        eb = np.stack([np.cos(2 * np.pi * f * b), np.sin(2 * np.pi * f * b)], 1)
        return np.exp(-0.5 * ((ea[:, None, :] - eb[None, :, :]) ** 2).sum(-1))

    ts = th["trend_scale"]
    cc = (th["co2.s_latent"] ** 2 * se(c, c, ts) + th["co2.s_wiggle"] ** 2 * se(c, c, th["co2.l_wiggle"])
          + th["co2.s_period"] ** 2 * periodic(c, c) + th["co2.s_mean"] ** 2
          + th["co2.s_noise"] ** 2 * np.eye(len(c)))
    tt = (th["temp.s_trend"] ** 2 * se(t, t, ts) + th["temp.s_wiggle"] ** 2 * se(t, t, th["temp.l_wiggle"])
          + th["temp.s_mean"] ** 2 + th["temp.s_noise"] ** 2 * np.eye(len(t)))
    ct = th["co2.s_latent"] * th["temp.s_trend"] * se(c, t, ts)
    return np.block([[cc, ct], [ct.T, tt]])


@pytest.mark.parametrize("seed", [0, 1])
def test_value_is_the_dense_normal(seed):
    cfg, data, raw = _problem(seed)
    y = np.concatenate([data["y_co2"].numpy(), data["y_T"].numpy()])
    K = _numpy_covariance(cfg, data, raw)
    want = -scipy.stats.multivariate_normal(np.zeros(len(y)), K).logpdf(y)
    value, _ = REF.value_and_grad(cfg, data, raw)
    assert value == pytest.approx(want, rel=1e-10)
    np.testing.assert_allclose(REF.covariance((data["x_co2"], data["x_T"]), REF.constrained(cfg, raw)).numpy(),
                               K, rtol=1e-12, atol=1e-14)


def test_gradient_is_the_values_slope():
    """Central differences of step 1e-4 in each raw leaf: truncation
    h²·f‴/6 reads about 1e-9 here, the factor's rounding of the value
    (about 1e-11) over 2h about 5e-8; both well inside 1e-6 of the leaf."""
    cfg, data, raw = _problem(2)
    _, grad = REF.value_and_grad(cfg, data, raw)
    h = 1e-4
    for k, (name, _) in enumerate(REF.leaves(cfg)):
        e = torch.zeros_like(raw)
        e[k] = h
        slope = (REF.value_and_grad(cfg, data, raw + e)[0] - REF.value_and_grad(cfg, data, raw - e)[0]) / (2 * h)
        assert float(grad[k]) == pytest.approx(slope, rel=1e-6, abs=1e-7), name


@pytest.fixture
def planted(monkeypatch):
    calls = Calls()
    monkeypatch.setattr(ps, "records", lambda: list(calls.recs))
    return calls


def _step(calls, t, cross_ms, reverse_ms):
    """A Mauna Loa fit step from t (ms): the stacked blocks inside `cov`,
    the factor; then the graph's reverse holding kernel 1's reverse rule."""
    root = calls.span("logpdf", None, (t * MS, (t + 30) * MS), (t * MS, (t + 20) * MS))
    cov = calls.span("cov", root, ((t + 1) * MS, (t + 8) * MS), (t * MS, (t + 1 + cross_ms) * MS), elems=16)
    cross = calls.span("cov.cross", cov, ((t + 2) * MS, (t + 7) * MS), (t * MS, (t + cross_ms) * MS),
                       blocks=4, elems=16)
    calls.span("chol.factor", root, ((t + 8) * MS, (t + 20) * MS), ((t + 9) * MS, (t + 19) * MS))
    b = t + 40
    rev = calls.span("graph.reverse", cov, (b * MS, (b + 10) * MS), (b * MS, (b + reverse_ms) * MS), elems=16)
    rev["thread"] = 2
    calls.span("cov.reverse", cross, ((b + 1) * MS, (b + 2) * MS), ((b + 1) * MS, (b + 2) * MS))


def test_the_graphs_readers_by_layer(planted):
    run = traced("fit", 3, lambda i, t: _step(planted, t, cross_ms=6, reverse_ms=9))
    assert REG.reader("cross_ms.train").read(run) == pytest.approx(6.0)
    assert REG.reader("graph_reverse_ms.train").read(run) == pytest.approx(9.0)
    # `cov_ms.train` keeps its meaning: `cov` holds `cov.cross`, and `cov.reverse` is its own
    assert REG.reader("cov_ms.train").read(run) == pytest.approx(7.0 + 1.0)
    assert REG.reader("graph_reverse_ms.train").read({**run, "kind": "query"}) is None


def test_a_program_without_the_graphs_spans_reads_none(planted):
    """The parent of these spans records `cov` alone: both readers read None."""
    def step(i, t):
        root = planted.span("logpdf", None, (t * MS, (t + 30) * MS), (t * MS, (t + 20) * MS))
        planted.span("cov", root, ((t + 1) * MS, (t + 8) * MS), (t * MS, (t + 7) * MS))

    run = traced("fit", 3, step)
    assert REG.reader("cross_ms.train").read(run) is None
    assert REG.reader("graph_reverse_ms.train").read(run) is None

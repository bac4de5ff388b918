"""`stheno_tpu_torch.inference` (`fit`, `fit_lbfgs`) against
`stheno_tpu.inference`, in f64 on the CPU: Adam's loss trace step for step
on a small Mauna Loa problem (rtol 1e-8), and L-BFGS, whose path differs
from optax's, to the same minimum (1e-6 relative) on a quadratic and on a
small GP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as st
import stheno_tpu.models  # noqa: F401  (st.models)
import stheno_tpu_torch as stt
import stheno_tpu_torch.models  # noqa: F401  (stt.models)
from stheno_tpu import params as JP
from stheno_tpu.inference import fit as jfit
from stheno_tpu.inference import fit_lbfgs as jfit_lbfgs
from stheno_tpu_torch import entry
from stheno_tpu_torch import params as P
from stheno_tpu_torch.convert import spec_from_numpy
from stheno_tpu_torch.inference import fit, fit_lbfgs
from test_torch_gppp import _mauna_loa_jax, _mauna_loa_jax_spec
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def test_adam_loss_trace_matches_reference():
    data = entry.mauna_loa_data(60, 40, torch.float64, device="cpu")
    jnlml, _ = _mauna_loa_jax(data)
    jres = jfit(jnlml, _mauna_loa_jax_spec(), num_steps=20, learning_rate=3e-2)
    res = fit(lambda t: entry.mauna_loa_nlml(t, data), spec_from_numpy(_mauna_loa_jax_spec(), device="cpu"),
              num_steps=20, learning_rate=3e-2)
    assert res.losses.shape == (20,) and res.losses.device.type == "cpu"
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(jres.losses), rtol=1e-8)
    np.testing.assert_allclose(res.theta.numpy(), np.asarray(jres.theta), rtol=1e-7, atol=1e-9)
    assert res.losses[-1] < res.losses[0]


def _quadratic(xp, c):
    return lambda p: 1.0 + xp.sum((p["a"] - c) ** 2) + (p["b"] - 0.5) ** 2 * 3.0


@pytest.mark.parametrize("case", ["quadratic", "gp"])
def test_lbfgs_reaches_the_reference_minimum(case):
    if case == "quadratic":
        c = np.asarray([0.3, -1.2, 2.0])
        jspec = dict(a=jnp.zeros(3), b=JP.positive(2.0))
        jobj, tobj = _quadratic(jnp, jnp.asarray(c)), _quadratic(torch, torch.as_tensor(c))
    else:
        rng = np.random.default_rng(0)
        x = np.sort(rng.uniform(-3, 3, 30))
        y = np.sin(x) + 0.1 * rng.normal(size=30)
        jspec = dict(v=JP.positive(1.0), l=JP.positive(1.0), s=JP.positive(0.5))

        def jobj(p):
            f = st.models.workloads.hyperparameter_model(p)
            return -st.logpdf(f(st.GPPPInput("f", jnp.asarray(x)), p["s"] ** 2), jnp.asarray(y))

        def tobj(p):
            f = stt.models.workloads.hyperparameter_model(p)
            return -stt.logpdf(f(stt.GPPPInput("f", torch.as_tensor(x)), p["s"] ** 2),
                               torch.as_tensor(y))

    jres = jfit_lbfgs(jobj, jspec, num_steps=60)
    res = fit_lbfgs(tobj, spec_from_numpy(jspec, device="cpu"), num_steps=60)
    jmin = float(jobj(jres.params))
    tmin = tobj(res.params).item()
    np.testing.assert_allclose(tmin, jmin, rtol=1e-6)
    assert res.losses.shape == (60,)


def test_fit_logs_to_stderr_every_n_steps(capsys):
    spec = dict(a=P.positive(2.0))
    res = fit(lambda p: (p["a"] - 1.0) ** 2, spec, num_steps=5, learning_rate=0.1, log_every=2)
    err = capsys.readouterr().err
    assert [ln.split()[2] for ln in err.splitlines()] == ["0", "2", "4"]
    assert res.params["a"].item() < 2.0

"""Faults planted underneath the timed path, for the control readings
(`controls.py`) and the tests: each patches the port (`stheno_tpu_torch`),
or the optimizer its fit uses, for the extent of a `with` block, and the
harness runs as it always does.

- `unchanged_state`: every Adam step returns θ and its state unchanged;
- `half_batch`: half of the observations left out (every other point), the
  fit's objective scaled by 2 as a mean over the rest would be;
- `altered_answer`: the first posterior mean of every request moved by
  `SHIFT`.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

SHIFT = 0.05
#: The faults each kind of traffic can have.
BY_KIND = {"fit": ("unchanged_state", "half_batch"),
           "query": ("half_batch", "altered_answer"),
           "predict": ("half_batch", "altered_answer")}


@contextlib.contextmanager
def unchanged_state():
    with mock.patch.object(torch.optim.Adam, "step", lambda self, closure=None: None):
        yield


def _half(t):
    return t[::2].contiguous()


@contextlib.contextmanager
def half_batch():
    from stheno_tpu_torch import entry, finite_gp
    from stheno_tpu_torch.inputs import GPPPInput

    nlml, neg_elbo = entry.nlml, entry.pseudo_points_neg_elbo
    predict, posterior = entry.predict, finite_gp.posterior

    def nlml_half(theta, x, y):
        return 2.0 * nlml(theta, _half(x), _half(y))

    def neg_elbo_half(t, data):
        return 2.0 * neg_elbo(t, (_half(data[0]), _half(data[1]), *data[2:]))

    def predict_half(theta, x, y, xp):
        return predict(theta, _half(x), _half(y), xp)

    def posterior_half(fx, y, *rest):
        fx = finite_gp.FiniteGP(fx.f, GPPPInput(fx.x.p, _half(fx.x.x)), fx.noise)
        return posterior(fx, _half(y), *rest)

    with mock.patch.multiple(entry, nlml=nlml_half, pseudo_points_neg_elbo=neg_elbo_half,
                             predict=predict_half), \
            mock.patch.object(finite_gp, "posterior", posterior_half):
        yield


@contextlib.contextmanager
def altered_answer():
    from stheno_tpu_torch import finite_gp

    mean = finite_gp.PosteriorGP.mean

    def mean_altered(self, x):
        m = mean(self, x).clone()
        m[0] += SHIFT
        return m

    with mock.patch.object(finite_gp.PosteriorGP, "mean", mean_altered):
        yield


def plant(name):
    return {"unchanged_state": unchanged_state, "half_batch": half_batch,
            "altered_answer": altered_answer}[name]()

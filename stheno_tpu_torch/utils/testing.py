"""Interface-conformance checks (counterpart of `stheno_tpu/utils/testing.py`):
shapes, symmetry of cov2 and cross_cov, PSD-ness by the least eigenvalue, and
var ≡ diag(cov), run against any process or `FiniteGP`.  Usable from the
tests and by users checking an affine op of their own."""

from __future__ import annotations

import numpy as np

from stheno_tpu_torch.graph import AbstractProcess, cross_cov, cross_var
from stheno_tpu_torch.inputs import input_length


def _np(t):
    return t.detach().cpu().numpy()


def check_process_interface(f, x0, x1, x2=None, atol=1e-9, f2=None):
    """Check the statistics interface of a process-like object.  `x0`, `x1`
    are input collections of equal length; `x2` (optional) may have another
    length.  With `f2` (a second process of the same programme) the cross
    rules are checked too."""
    n0 = input_length(x0)
    n1 = input_length(x1)
    assert n0 == n1, "test misuse: x0 and x1 must have equal length"

    m = f.mean(x0)
    assert tuple(m.shape) == (n0,), f"mean shape {tuple(m.shape)} != ({n0},)"

    K = _np(f.cov(x0))
    assert K.shape == (n0, n0)
    np.testing.assert_allclose(K, K.T, atol=atol, err_msg="cov not symmetric")
    evals = np.linalg.eigvalsh(K.astype(np.float64))
    assert evals.min() > -1e-6, f"cov not PSD: min eig {evals.min()}"

    v = _np(f.var(x0))
    assert v.shape == (n0,)
    np.testing.assert_allclose(v, np.diagonal(K), atol=max(atol, 1e-8), err_msg="var != diag(cov)")

    K01 = _np(f.cov2(x0, x1))
    assert K01.shape == (n0, n1)
    np.testing.assert_allclose(K01, _np(f.cov2(x1, x0)).T, atol=atol,
                               err_msg="cov2(x0,x1) != cov2(x1,x0)^T")

    v01 = _np(f.var2(x0, x1))
    assert v01.shape == (n0,)
    np.testing.assert_allclose(v01, np.diagonal(K01), atol=max(atol, 1e-8),
                               err_msg="var2 != diag(cov2)")

    if x2 is not None:
        K02 = _np(f.cov2(x0, x2))
        assert K02.shape == (n0, input_length(x2))
        np.testing.assert_allclose(K02, _np(f.cov2(x2, x0)).T, atol=atol)

    if f2 is not None and isinstance(f, AbstractProcess):
        C = _np(cross_cov(f, f2, x0, x1))
        np.testing.assert_allclose(C, _np(cross_cov(f2, f, x1, x0)).T, atol=atol,
                                   err_msg="cross_cov not transpose-symmetric")
        np.testing.assert_allclose(_np(cross_var(f, f2, x0, x1)), np.diagonal(C),
                                   atol=max(atol, 1e-8), err_msg="cross_var != diag(cross_cov)")

    # the joint [x0; x2-or-x1] covariance must be PSD as well
    xj = x2 if x2 is not None else x1
    Kj = np.block([[K, _np(f.cov2(x0, xj))], [_np(f.cov2(xj, x0)), _np(f.cov(xj))]])
    evj = np.linalg.eigvalsh(Kj.astype(np.float64))
    assert evj.min() > -1e-6, f"joint cov not PSD: min eig {evj.min()}"


def check_finite_gp(generator, fx, atol=1e-8):
    """Shape and consistency checks of a `FiniteGP` (rand, logpdf,
    marginals); returns one sample.  `generator` is a `torch.Generator` on
    the covariance's device, or None."""
    from stheno_tpu_torch import finite_gp as fgp

    n = len(fx)
    m, K = fx.mean_and_cov()
    assert tuple(m.shape) == (n,) and tuple(K.shape) == (n, n)
    m2, v = fx.mean_and_var()
    np.testing.assert_allclose(_np(m), _np(m2), atol=atol)
    np.testing.assert_allclose(_np(v), np.diagonal(_np(K)), atol=max(atol, 1e-8))

    y = fgp.rand(generator, fx)
    assert tuple(y.shape) == (n,)
    ys = fgp.rand(generator, fx, 3)
    assert tuple(ys.shape) == (n, 3)

    lp = fgp.logpdf(fx, y)
    assert tuple(lp.shape) == ()
    lps = fgp.logpdf(fx, ys)
    assert tuple(lps.shape) == (3,)
    return y

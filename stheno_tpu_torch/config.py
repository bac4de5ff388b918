"""Numeric policy and scoped tuning overrides (counterpart of
`stheno_tpu/config.py`).

- Default observation noise (jitter) depends on the dtype; `default_float`
  is torch's default dtype, the counterpart of the reference's x64 switch.
- Thread-local scoped overrides of the blocked linear algebra: the GEMM
  precision of its f32 products (`gemm_precision`, and `bwd_precision` for
  the Cholesky's reverse rule alone), the Cholesky backend
  (`chol_backend`), the reverse rule's knobs (`bwd_params`), the fused
  MvNormal logpdf's routing (`logpdf_fused`), and the raw keys
  `base_cholesky` and `base_tri_inv`, which swap the factoriser and the
  triangular inverse of the blocked Cholesky's base blocks
  (`scoped(base_cholesky=fn)`).  A scope cannot leak, even on an exception:

      with stheno_tpu_torch.config.gemm_precision("high"):
          L = cholesky_psd(K)

The precisions keep the reference's names and give them the card's meaning
(`ops/blocked_cholesky.py:_mm`): 'highest' is full fp32 (the port's
default; the reference's is 'high'), 'high' is 3xTF32 (each f32 operand
split into a TF32 head and its remainder, three tensor-core products), and
'default' is one TF32 product.  f64 products ignore them.  `snapshot()` is
the hashable active configuration, with the reference's keys.
"""

from __future__ import annotations

import enum
import threading
from contextlib import contextmanager

import torch

#: Default observation noise applied by ``f(x)`` when none is given.
_DEFAULT_JITTER = {
    torch.float64: 1e-12,
    torch.float32: 1e-6,
    torch.bfloat16: 1e-3,
}


def default_float():
    """The default float dtype: torch's default dtype (float32 unless the
    caller set float64), as the reference's is f64 only under x64."""
    return torch.get_default_dtype()


def default_jitter(dtype) -> float:
    return _DEFAULT_JITTER.get(dtype, 1e-6)


_tls = threading.local()


def _override_stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def active_override(key, default):
    """Innermost scoped override for `key`, else `default`."""
    for frame in reversed(_override_stack()):
        if key in frame:
            return frame[key]
    return default


@contextmanager
def scoped(**overrides):
    """Push raw override key/values for the dynamic extent of the block."""
    _override_stack().append(overrides)
    try:
        yield
    finally:
        _override_stack().pop()


#: Reverse-rule algorithms of the blocked Cholesky: "iter" (panel sweep),
#: "rec" (recursive two-way split), "fused" (panel sweep with its solves
#: folded into GEMMs against the panel inverses).
BWD_MODES = ("iter", "rec", "fused")


def bwd_params(base=None, via_inv=None, mode=None, block=None):
    """Scope the blocked-Cholesky reverse rule's knobs (only the ones given):
    recursion base, whether its solves apply diagonal blocks through their
    explicit inverses (`via_inv`), the algorithm (`mode`, one of
    `BWD_MODES`) and the panel block: `with bwd_params(mode="fused"): ...`."""
    if mode is not None and mode not in BWD_MODES:
        raise ValueError(f"unknown backward mode {mode!r}; expected one of {BWD_MODES}")
    frame = {}
    if base is not None:
        frame["bwd_base"] = base
    if via_inv is not None:
        frame["bwd_via_inv"] = via_inv
    if mode is not None:
        frame["bwd_mode"] = mode
    if block is not None:
        frame["bwd_block"] = block
    return scoped(**frame)


def chol_backend(name):
    """Scope the Cholesky backend routing: 'auto' | 'blocked' | 'torch'."""
    if name not in ("auto", "blocked", "torch"):
        raise ValueError(f"unknown Cholesky backend {name!r}")
    return scoped(chol_backend=name)


def logpdf_fused(mode):
    """Scope the fused MvNormal logpdf (`ops.chol.mvn_logpdf_psd`): 'off'
    (the default), 'auto' (wherever the blocked Cholesky would be used) or
    'on'."""
    if mode not in ("off", "auto", "on"):
        raise ValueError(f"unknown fused-logpdf mode {mode!r}; expected 'off', 'auto' or 'on'")
    return scoped(logpdf_fused=mode)


class Precision(enum.Enum):
    """GEMM precision of the blocked linear algebra's f32 products, by the
    reference's names (`lax.Precision`); see the module note for what each
    means on the card."""

    DEFAULT = "default"
    HIGH = "high"
    HIGHEST = "highest"


def _norm_precision(p):
    """A `Precision` from a member or its name in any case; None raises
    `ValueError` and an unknown name `KeyError`, as in the reference."""
    if p is None:
        raise ValueError("precision must be a Precision or 'default'|'high'|'highest' — got None")
    if isinstance(p, str):
        return Precision[p.upper()]
    if isinstance(p, Precision):
        return p
    raise TypeError(f"precision must be a Precision or 'default'|'high'|'highest', got {p!r}")


def gemm_precision(p):
    """Scope the precision of every f32 GEMM of the blocked Cholesky, its
    triangular solves and inverses, LAUUM and the distributed tier's panel
    loops: `with gemm_precision('high'): ...`.

    On an H100, 'high' (3xTF32) held the flagship's and the −ELBO step's
    f32 limits, but not the gradient-enhanced GP's (condition about
    2.4e5): `accuracy_probe --part precision` read its noise gradient 5.9e-2
    of the largest component at data seed 2 (limit 2e-2; 'highest'
    1.3e-3), and `chip_smoke.py` its f″ posterior mean 1.28e-3 of
    max|mean64| at seed 0 (limit 1e-3; 'highest' 3.8e-4), `PERF.md` §6.
    Ill-conditioned f32 covariances need 'highest', the default."""
    return scoped(gemm_precision=_norm_precision(p))


def bwd_precision(p):
    """Scope the GEMM precision of the blocked Cholesky's reverse rule alone
    (None: follow the forward's).  'default' (one TF32 pass) is a reading,
    not a recommendation: the reference measured its gradients 56× wrong
    (reference `blocked_cholesky.py:626-632`), the cancellation in K̄
    amplifying the product's error."""
    return scoped(bwd_precision=None if p is None else _norm_precision(p))


def snapshot():
    """Hashable tuple of the active tuning configuration (scoped overrides
    merged over the module defaults), with the reference's keys in its
    order.  The base factorisers are compared by identity."""
    from stheno_tpu_torch.ops import blocked_cholesky as _bc
    from stheno_tpu_torch.ops import chol as _chol

    return (
        ("gemm_precision", _bc._active_prec()),
        ("bwd_precision", _bc._active_bwd_prec()),
        ("bwd_params", _bc._active_bwd_params()),
        ("chol_backend", active_override("chol_backend", _chol.CHOL_BACKEND)),
        ("logpdf_fused", active_override("logpdf_fused", _chol.LOGPDF_FUSED)),
        ("base_cholesky", active_override("base_cholesky", _bc._BASE_CHOL)),
        ("base_tri_inv", active_override("base_tri_inv", _bc._BASE_TRI_INV)),
    )

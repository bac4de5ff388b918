"""Numeric policy and scoped tuning overrides (counterpart of
`stheno_tpu/config.py:26-38` and `:71-138`).

- Default observation noise (jitter) depends on the dtype.
- Thread-local scoped overrides of the blocked linear algebra: the Cholesky
  backend (`chol_backend`), the reverse rule's knobs (`bwd_params`), the
  fused MvNormal logpdf's routing (`logpdf_fused`), and the raw keys
  `base_cholesky` and `base_tri_inv`, which swap the factoriser and
  the triangular inverse of the blocked Cholesky's base blocks
  (`scoped(base_cholesky=fn)`).  A scope cannot leak, even on an exception:

      with stheno_tpu_torch.config.chol_backend("blocked"):
          L = cholesky_psd(K)

The reference's GEMM-precision knobs (`gemm_precision`, `bwd_precision`) have
no counterpart: every GEMM of the port runs in full fp32 (see
`ops/blocked_cholesky.py`).  On the card a lower precision would mean TF32,
not the TPU's three-pass bf16.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

#: Default observation noise applied by ``f(x)`` when none is given.
_DEFAULT_JITTER = {
    torch.float64: 1e-12,
    torch.float32: 1e-6,
    torch.bfloat16: 1e-3,
}


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

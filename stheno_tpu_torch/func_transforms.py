"""Where a tensor stands among `torch.func`'s transforms.

Some of the port's code takes another route under a transform: an
autograd.Function whose in-place or batched form `torch.func` cannot take
(`_AddDiagInPlace`, kernel 1's backward), and the Cholesky routing, which
sends a vmapped covariance to `torch.linalg` and never to the blocked
factorisation's Python panel loops and ctypes launches.
"""

from __future__ import annotations

import torch

_F = torch._C._functorch


def under_transform() -> bool:
    """True inside a `torch.func` transform (vmap, grad, ...)."""
    return _F.peek_interpreter_stack() is not None


def is_vmapped(t) -> bool:
    """True for a tensor that carries a `torch.func.vmap` batch dimension,
    under any other transform's wrappers (a (C, N, N) batch of covariances
    that looks like one (N, N) matrix)."""
    while torch.is_tensor(t) and _F.is_functorch_wrapped_tensor(t):
        if _F.is_batchedtensor(t):
            return True
        t = _F.get_unwrapped(t)
    return False

"""Where a tensor stands among `torch.func`'s transforms.

Some of the port's code takes another route under a transform: an
autograd.Function whose in-place or batched form `torch.func` cannot take
(`_AddDiagInPlace`, kernel 1's backward), and the Cholesky routing, which
sends a vmapped covariance to `torch.linalg` and never to the blocked
factorisation's Python panel loops and ctypes launches.

`lowered_jvp` runs the forward-mode rule of an autograd.Function so that
the transforms outside the current `torch.func.jvp` see its ops: nested
jvps (∂ₓ∂_y k for a derivative process) and reverse mode over a jvp then
differentiate the rule itself.
"""

from __future__ import annotations

import torch
from torch.autograd.forward_ad import _set_fwd_grad_enabled

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


def lowered_jvp(rule, *args):
    """`rule(*args)` for the `jvp` staticmethod of an autograd.Function
    (`args` its saved inputs and tangents, None where absent).

    PyTorch calls a Function's `jvp` with forward-mode AD switched off at
    every level, so an enclosing `torch.func.jvp` would see a constant
    tangent (a nested jvp through the Function would return zeros).  Under
    a jvp transform the rule runs one level down instead, as
    `torch._functorch.autograd_function` runs a Function's forward: its
    tensors unwrapped from the current level, forward mode on, the current
    interpreter lowered, and its result wrapped back.  Outside `torch.func`
    (plain `torch.autograd.forward_ad`) the rule runs as it is."""
    interp = _F.peek_interpreter_stack()
    if interp is None or interp.key() != _F.TransformType.Jvp:
        return rule(*args)
    from torch._functorch.pyfunctorch import coerce_cinterpreter

    interp = coerce_cinterpreter(interp)
    level = interp.level()
    args = [_F._unwrap_for_grad(a, level) if torch.is_tensor(a) else a for a in args]
    with _set_fwd_grad_enabled(True), interp.lower():
        out = rule(*args)
    return _F._wrap_for_grad(out, level)

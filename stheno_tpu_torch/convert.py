"""Carry a GP programme's numbers across from numpy (or the JAX package, by
way of `np.asarray`) into tensors, and pick the device of an entry point:
hyperparameter trees (`theta_from_numpy`), parameter specs
(`spec_from_numpy`), SVGP variational states (`svgp_from_numpy`),
likelihoods (`likelihood_from_numpy`), the samplers' states
(`chain_state_from_numpy`, `warmup_state_from_numpy`), the Neural Kernel
Network's layers (`nkn_layers_from_numpy`), random Fourier feature
bases (`fourier_basis_from_numpy`) and the weights of a flax MLP
(`mlp_from_numpy`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """`torch.device(device)`, refusing a CUDA device where there is none:
    the port's entry points run on the card unless the caller asks for the
    CPU, and never carry on quietly on the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "stheno_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions of the kernels on the CPU"
        )
    return dev


def theta_from_numpy(tree, dtype=None, device="cuda", requires_grad=True):
    """Turn a nested dict/list/tuple of numpy arrays (or scalars) into
    tensors on `device`; floating leaves are cast to `dtype` when given and
    made autograd leaves when `requires_grad`."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: theta_from_numpy(v, dtype, dev, requires_grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(theta_from_numpy(v, dtype, dev, requires_grad) for v in tree)
    t = torch.tensor(np.asarray(tree), device=dev)
    if t.is_floating_point():
        if dtype is not None:
            t = t.to(dtype)
        t.requires_grad_(requires_grad)
    return t


def _closure_values(fn):
    """The values a closure closes over, by name."""
    cells = fn.__closure__ or ()
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in cells)))


def spec_from_numpy(spec, dtype=None, device="cuda"):
    """Carry a parameter spec of the JAX package (`stheno_tpu.params`) into
    the port's, on `device`: each `Param` keeps its raw value, its bijector
    (by the name of the constructor that made it: `positive`,
    `softplus_positive` or `bounded`) and its bounds; each `Fixed` keeps its
    value; a plain leaf is carried as a tensor.  Every number is read with
    `np.asarray`, so nothing of JAX is imported here.  Floating values are
    cast to `dtype` when given."""
    from stheno_tpu_torch import params as P

    dev = resolve_device(device)

    def tensor(v):
        t = torch.tensor(np.asarray(v), device=dev)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    def carry(s):
        if isinstance(s, dict):
            return {k: carry(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(carry(v) for v in s)
        if hasattr(s, "raw") and hasattr(s, "transform"):  # a Param
            kind = s.transform.__qualname__.split(".")[0]
            if kind not in P.TRANSFORMS:
                raise ValueError(f"spec_from_numpy: unknown bijector {s.transform.__qualname__!r}")
            bounds = {k: float(np.asarray(v)) for k, v in _closure_values(s.transform).items()}
            return P.Param(tensor(s.raw), *P.TRANSFORMS[kind](**bounds))
        if type(s).__name__ == "Fixed":
            return P.Fixed(tensor(s.value))
        return tensor(s)

    return carry(spec)


def svgp_from_numpy(svgp, fz, dtype=None, device="cuda"):
    """The port's `SVGP` over the inducing FiniteGP `fz` (built with the
    port), with the variational state `q_mu`, `q_sqrt` of `svgp` (the JAX
    package's, or anything holding those two arrays) read with
    `np.asarray` onto `device`, cast to `dtype` when given."""
    from stheno_tpu_torch.inference.svgp import SVGP

    dev = resolve_device(device)

    def tensor(v):
        t = torch.tensor(np.asarray(v), device=dev)
        return t.to(dtype) if dtype is not None else t

    return SVGP(fz, tensor(svgp.q_mu), tensor(svgp.q_sqrt))


def likelihood_from_numpy(lik, dtype=None, device="cuda"):
    """The port's likelihood of the same class as `lik` (the JAX package's
    `GaussianLikelihood`, `BernoulliLikelihood`, `PoissonLikelihood` or
    `StudentTLikelihood`, found by name): its structural fields (`link`,
    `n_gh`) as they are, each numeric one read with `np.asarray` into a
    tensor on `device`, cast to `dtype` when given."""
    from stheno_tpu_torch.inference import likelihoods as L

    name = type(lik).__name__
    cls = getattr(L, name, None)
    if cls is None or name not in L.__all__ or name == "Likelihood":
        raise ValueError(f"likelihood_from_numpy: unknown likelihood {name!r}")
    dev = resolve_device(device)
    kwargs = {}
    for fld in dataclasses.fields(cls):
        v = getattr(lik, fld.name)
        if not fld.metadata.get("static"):
            v = torch.tensor(np.asarray(v), device=dev)
            v = v.to(dtype) if dtype is not None else v
        kwargs[fld.name] = v
    return cls(**kwargs)


def _tensors(fields, dtype, device):
    dev = resolve_device(device)

    def tensor(v):
        t = torch.tensor(np.asarray(v), device=dev)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    return [tensor(v) for v in fields]


def chain_state_from_numpy(state, dtype=None, device="cuda"):
    """The port's `ChainState` from the fields `q`, `logp`, `grad`, `eps`,
    `inv_mass` of `state` (the JAX package's `ChainState`, or anything
    holding those arrays), read with `np.asarray` onto `device` and cast to
    `dtype` when given: sampling in the port can go on from a warmup the
    reference adapted."""
    from stheno_tpu_torch.inference.hmc import ChainState

    return ChainState(*_tensors([getattr(state, f) for f in ChainState._fields], dtype, device))


def warmup_state_from_numpy(state, dtype=None, device="cuda"):
    """The port's `WarmupState` from the JAX package's (its `q`, `logp`,
    `grad`, the dual-averaging state `da`, the Welford state `wf` and
    `inv_mass`), read with `np.asarray` onto `device`, cast to `dtype` when
    given."""
    from stheno_tpu_torch.inference.hmc import DualAveragingState, WarmupState, WelfordState

    da = DualAveragingState(*_tensors([getattr(state.da, f) for f in DualAveragingState._fields],
                                      dtype, device))
    wf = WelfordState(*_tensors([getattr(state.wf, f) for f in WelfordState._fields], dtype, device))
    q, logp, grad, inv_mass = _tensors([state.q, state.logp, state.grad, state.inv_mass], dtype,
                                       device)
    return WarmupState(q, logp, grad, da, wf, inv_mass)


def nkn_layers_from_numpy(layers, dtype=None, device="cuda"):
    """The port's NKN layers from the JAX package's (or anything with the
    same fields, found by class name): a `LinearLayer`'s `log_w` and
    `log_b` (None stays None) read with `np.asarray` onto `device`, cast
    to `dtype` when given; a `ProductLayer` keeps its `stride`."""
    from stheno_tpu_torch.kernels.nkn import LinearLayer, ProductLayer

    out = []
    for layer in layers:
        name = type(layer).__name__
        if name == "LinearLayer":
            (w,) = _tensors([layer.log_w], dtype, device)
            b = None if layer.log_b is None else _tensors([layer.log_b], dtype, device)[0]
            out.append(LinearLayer(w, b))
        elif name == "ProductLayer":
            out.append(ProductLayer(int(layer.stride)))
        else:
            raise ValueError(f"nkn_layers_from_numpy: unknown layer {name!r}")
    return tuple(out)


def fourier_basis_from_numpy(basis, transform=None, dtype=None, device="cuda"):
    """The port's `FourierBasis` holding the `omega`, `phase` and `scale`
    draws of `basis` (the JAX package's, or anything holding those three
    arrays), read with `np.asarray` onto `device` and cast to `dtype` when
    given, with the port's input map `transform` (None: linear features)."""
    from stheno_tpu_torch.sampling import FourierBasis

    omega, phase, scale = _tensors([basis.omega, basis.phase, basis.scale], dtype, device)
    return FourierBasis(omega, phase, scale, transform)


def mlp_from_numpy(params, dtype=None, device="cuda"):
    """The weights of a flax MLP as the port's `torch.func.functional_call`
    dict: each `Dense` layer `name` (flax's `{'params': {name: {'kernel':
    (in, out), 'bias': (out,)}}}`, or the inner dict, read with
    `np.asarray`) becomes `name.weight` (out, in), as `nn.Linear` holds it,
    and `name.bias`, on `device` and cast to `dtype` when given."""
    layers = params.get("params", params)
    out = {}
    for name in sorted(layers):
        kernel, bias = _tensors([np.asarray(layers[name]["kernel"]).T,
                                 layers[name]["bias"]], dtype, device)
        out[f"{name}.weight"], out[f"{name}.bias"] = kernel.contiguous(), bias
    return out

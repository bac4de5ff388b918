"""`stheno_tpu_torch.params` and `convert.spec_from_numpy` against
`stheno_tpu.params`, in f64 on the CPU: the flat θ₀ of a spec (its leaf
order: dict keys sorted, `Fixed` left out), `unflatten` at θ₀ and at another
θ, its gradient, and round trips through each bijector."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stheno_tpu import params as JP
from stheno_tpu_torch import entry
from stheno_tpu_torch import params as P
from stheno_tpu_torch.convert import spec_from_numpy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _spec(m, arr):
    """One spec of every kind of leaf, nested, in package `m`."""
    return dict(
        z=m.positive(2.0, lb=0.5),
        a=dict(w=m.bounded(0.3, -1.0, 2.0), s=m.softplus_positive(0.7)),
        fixed=m.fixed(arr([1.0, 2.0])),
        plain=arr([0.25, -0.5, 1.5]),
        seq=[m.positive(arr([0.1, 0.2])), m.fixed(3.0), m.bounded(0.9, 0.0, 1.0)],
    )


def _flat_values(tree):
    """The leaves of a constrained tree in sorted-key order, as numpy."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _flat_values(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _flat_values(t)]
    return [np.asarray(tree.detach() if torch.is_tensor(tree) else tree, dtype=np.float64)]


@pytest.mark.parametrize("build", ["constructors", "spec_from_numpy"])
def test_init_and_unflatten_match_reference(build):
    jspec = _spec(JP, jnp.asarray)
    if build == "constructors":
        tspec = _spec(P, lambda v: torch.tensor(v, dtype=torch.float64))
    else:
        tspec = spec_from_numpy(jspec, device="cpu")
    jth, junf = JP.init(jspec)
    th, unf = P.init(tspec)
    assert th.dtype == torch.float64 and th.shape == jth.shape
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), rtol=1e-15, atol=0)
    theta1 = np.random.default_rng(0).normal(size=th.shape[0])
    for t_jax, t_torch in ((jth, th), (jnp.asarray(theta1), torch.as_tensor(theta1))):
        for got, want in zip(_flat_values(unf(t_torch)), _flat_values(junf(t_jax))):
            np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-15)
    # the round trip: unflatten(θ₀) is the spec's constrained value
    for got, want in zip(_flat_values(unf(th)), _flat_values(P.constrain(tspec))):
        np.testing.assert_allclose(got, want, rtol=1e-14)
    assert list(unf(th)) == list(tspec)  # the spec's own key order


def test_unflatten_gradient_matches_reference():
    jspec = _spec(JP, jnp.asarray)
    jth, junf = JP.init(jspec)
    w = np.random.default_rng(1).normal(size=12)  # one weight per constrained number

    def jsum(th):
        vals = jnp.concatenate([jnp.ravel(v) for v in jax.tree_util.tree_leaves(junf(th))])
        return jnp.sum(vals * w)

    jg = jax.grad(jsum)(jth)
    th, unf = P.init(spec_from_numpy(jspec, device="cpu"))
    th = th.clone().requires_grad_(True)
    vals = torch.cat([torch.as_tensor(v).reshape(-1) for v in _leaves(unf(th))])
    (g,) = torch.autograd.grad((vals * torch.as_tensor(w)).sum(), th)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-13, atol=1e-15)


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _leaves(t)]
    return [tree]


def test_mauna_loa_spec_theta0_matches_reference():
    """The example's spec, built by each package's constructors, gives one θ₀."""
    pos = JP.positive
    jspec = dict(
        trend_scale=pos(0.1),
        co2=dict(s_latent=pos(0.3), s_wiggle=pos(0.3), l_wiggle=pos(5.0), s_period=pos(0.3),
                 freq=JP.fixed(1.0), s_noise=pos(0.1), s_mean=pos(1.0)),
        temp=dict(s_trend=pos(1.0), s_wiggle=pos(1.0), l_wiggle=pos(0.5), s_noise=pos(0.1),
                  s_mean=pos(1.0)),
    )
    jth, junf = JP.init(jspec)
    th, unf = P.init(entry.mauna_loa_spec(torch.float64, device="cpu"))
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), rtol=1e-15)
    assert th.shape == (12,)  # freq is fixed
    np.testing.assert_allclose(unf(th)["co2"]["freq"].item(), 1.0)
    th32, _ = P.init(entry.mauna_loa_spec(torch.float32, device="cpu"))
    assert th32.dtype == torch.float32


@pytest.mark.parametrize("kind,args", [("positive", (0.37, 0.1)), ("softplus_positive", (25.0, 0.0)),
                                       ("bounded", (0.8, -1.0, 1.0))])
def test_bijectors_round_trip(kind, args):
    p = getattr(P, kind)(*args)
    assert p.raw.dtype == torch.float64
    np.testing.assert_allclose(p.value.item(), args[0], rtol=1e-14)
    np.testing.assert_allclose(p.inverse(p.value).item(), p.raw.item(), rtol=1e-12)
    jp = getattr(JP, kind)(*args)
    np.testing.assert_allclose(p.raw.item(), float(jp.raw), rtol=1e-14)


def test_leaves_keep_their_tensor_dtype_and_spec_from_numpy_casts():
    p = P.positive(torch.tensor(0.5, dtype=torch.float32))
    assert p.raw.dtype == torch.float32
    spec = spec_from_numpy(dict(a=JP.positive(0.5), b=JP.fixed(2.0)), dtype=torch.float32, device="cpu")
    th, unf = P.init(spec)
    assert th.dtype == torch.float32 and unf(th)["b"].dtype == torch.float32
    with pytest.raises(ValueError, match="bijector"):
        spec_from_numpy(dict(a=JP.Param(jnp.asarray(0.0), transform=lambda r: r, inverse=lambda v: v)),
                        device="cpu")

"""Data-parallel SVGP training (counterpart of `stheno_tpu/parallel/svgp.py`).

The uncollapsed SVGP bound (`inference.svgp`) is a sum of per-point
expected log-likelihoods minus one KL, the shape data parallelism wants:
each rank takes its shard of the minibatch, computes its partial data term
against the replicated M×M inducing factors, and a `psum` adds them.
Gradients flow through the collective with `shard_map`'s rules
(`collectives`), so one backward pass of the sharded bound gives, on every
rank, the single-device gradient: no separate gradient all-reduce.

`svgp_elbo_dp` equals `svgp_elbo` on the same batch (to ~1e-10 in f64),
so the single-device training loop carries over unchanged.
"""

from __future__ import annotations

import math

import torch

from stheno_tpu_torch.finite_gp import DiagNoise, _like
from stheno_tpu_torch.inference.svgp import SVGP, _q_marginals, _svgp_factors
from stheno_tpu_torch.inputs import BlockData, GPPPInput
from stheno_tpu_torch.parallel.collectives import Axis, psum, pvary_tree, shard
from stheno_tpu_torch.parallel.mesh import shard_rows
from stheno_tpu_torch.parallel.multihost import global_mesh


def data_mesh(p=None, axis_name="data", device_type="cuda"):
    """1-D mesh over the job's ranks for batch sharding (`p`, if given,
    must be the job's size)."""
    mesh = global_mesh((axis_name,), device_type=device_type)
    if p is not None and p != mesh.size():
        raise ValueError(f"a {axis_name!r} mesh spans the job's {mesh.size()} ranks, not {p}")
    return mesh


def shard_batch(mesh, arr, axis_name="data"):
    """This rank's rows of a (N, ...) batch given whole."""
    return shard_rows(mesh, arr, axis_name=axis_name)


def _split_inputs(x):
    """(raw tensor, rebuild) for the supported tagged-input forms."""
    if isinstance(x, GPPPInput):
        if isinstance(x.x, (GPPPInput, BlockData)):
            raise NotImplementedError(
                "svgp_elbo_dp: nested tagged inputs are not shardable as one batch axis; "
                "shard the underlying programme's inputs")
        return torch.as_tensor(x.x), lambda a, _p=x.p: GPPPInput(_p, a)
    if isinstance(x, BlockData):
        raise NotImplementedError("svgp_elbo_dp: BlockData batches are ragged; shard per block")
    return torch.as_tensor(x), lambda a: a


def svgp_elbo_dp(mesh, svgp: SVGP, fx, y, scale=1.0, likelihood=None, axis_name="data"):
    """`svgp_elbo` with the minibatch sharded over `axis_name`.

    `fx` and `y` are the whole minibatch on every rank (inputs a raw tensor
    or a `GPPPInput`; N must divide over the axis).  The inducing factors
    are computed once on every rank; each rank evaluates its shard's
    expected log-likelihood; a `psum` assembles the data term.  Value and
    gradients (hyperparameters, variational parameters, noise) match the
    single-device `svgp_elbo`."""
    ax = Axis(mesh, axis_name)
    x_arr, rebuild = _split_inputs(fx.x)
    n = x_arr.shape[0]
    if n % ax.size != 0:
        raise ValueError(f"batch size {n} must divide over {ax.size} devices")
    Luu, q_sqrt = _svgp_factors(svgp)
    if likelihood is None:
        if not isinstance(fx.noise, DiagNoise):
            raise TypeError("svgp_elbo_dp requires diagonal observation noise "
                            "(or pass an explicit likelihood=)")
        noise_diag = fx.noise.diag(n)
    # replicated factors entering rank-local work (one map keeps fx.f and
    # svgp.fz.f one object when they are, as the programme check needs)
    svgp_r, f_r, Luu_r, q_sqrt_r, x_r = pvary_tree((svgp, fx.f, Luu, q_sqrt, x_arr), ax)
    a, b = ax.rows(n)
    mu, var = _q_marginals(svgp_r, Luu_r, q_sqrt_r, f_r, rebuild(x_r[a:b]))
    y_loc = shard(_like(y, mu), ax)
    if likelihood is not None:
        ell_loc = likelihood.variational_expectation(mu, var, y_loc)
    else:
        s = shard(_like(noise_diag, mu), ax)
        ell_loc = torch.sum(-0.5 * (torch.log(2.0 * math.pi * s) + (y_loc - mu) ** 2 / s + var / s))
    ell = psum(ell_loc, ax)
    m = svgp.q_mu.shape[0]
    kl = 0.5 * (
        torch.dot(svgp.q_mu, svgp.q_mu)
        + torch.sum(q_sqrt * q_sqrt)
        - m
        - 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(q_sqrt))))
    )
    return scale * ell - kl


__all__ = ["svgp_elbo_dp", "data_mesh", "shard_batch"]

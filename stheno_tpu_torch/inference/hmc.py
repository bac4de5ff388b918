"""HMC and NUTS over batched chains (counterpart of
`stheno_tpu/inference/hmc.py`): NUTS with Stan window adaptation, plain HMC,
segmented warmup and resumable sampling.

The reference writes one chain and batches it with `jax.vmap`: its NUTS is a
`lax.while_loop` nest that `vmap` masks chain by chain.  Here the batch is
written out.  Every state tensor has a leading chain axis (C, ...); each
chain keeps its own step size (C,) and diagonal inverse mass (C, d); a chain
whose trajectory has ended (a U-turn, a divergence) is frozen by masks while
the others go on.  The loops run on the host, which asks the card once per
leapfrog whether any chain is still active.  Every leapfrog evaluates the
log-density and its gradient for all chains at once, through
`torch.func.vmap(torch.func.grad_and_value(logdensity))`
(`BatchedLogDensity`); a GP log-density goes through one batched launch of
kernel 1 and a batched `torch.linalg` factor per evaluation.

- NUTS is the iterative, fixed-memory formulation: a checkpoint stack of
  `max_depth + 1` slots replaces recursion; multinomial sampling inside a
  subtree, biased progressive sampling across doublings, the generalised
  U-turn criterion with velocity endpoints, divergence at ΔH > 1000.
- Warmup is Stan's window adaptation: dual averaging of the step size and
  Welford estimates of the diagonal mass matrix in doubling windows.

Randomness: a top-level integer `seed`.  Chain initialisation, each warmup
iteration and each draw take their own `torch.Generator`, seeded from
(seed, phase, index), which draws every chain's numbers at once.  So a
segmented warmup, or a sampling run resumed with `sample_offset`, gives the
uninterrupted run's draws bit for bit on the same device.  The draws do not
match the reference's, whose keys are split per chain.
"""

from __future__ import annotations

import math
import warnings
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import numpy as np
import torch

from stheno_tpu_torch.inference.diagnostics import potential_scale_reduction
from stheno_tpu_torch.tree import ravel_pytree

__all__ = ["nuts_kernel", "hmc_kernel", "run_nuts", "nuts_warmup", "warmup_result", "WarmupState",
           "ChainState", "NUTSInfo", "window_adaptation_schedule", "BatchedLogDensity", "fold_in"]

_DIVERGENCE_THRESHOLD = 1000.0

#: Post-run mixing check threshold (split-R̂).
RHAT_WARN_THRESHOLD = 1.05

# phases of the generators' seeds
_INIT, _WARMUP, _SAMPLE, _SMC = 0, 1, 2, 3


def generator(seed: int, phase: int, index: int, device) -> torch.Generator:
    """The `torch.Generator` of step `index` of `phase`, seeded from
    (seed, phase, index) alone, on `device`."""
    if seed < 0:
        raise ValueError(f"seed must be a non-negative integer, got {seed}")
    hi, lo = np.random.SeedSequence([int(seed), int(phase), int(index)]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(hi) << 31) ^ int(lo))
    return gen


class GeneratorDraws:
    """A transition's random numbers for C chains, from one generator, in a
    fixed order: the momentum, then per doubling j the direction's and the
    acceptance's uniforms and the 2^j leaves' uniforms (NUTS), or the
    acceptance's uniform (HMC).  Every chain's numbers are drawn whether it
    is still active or not, so that a chain's draws do not depend on the
    others'.

    `rows=(a, b)` keeps chains [a, b) of the `batch` drawn: the numbers
    those chains get in the whole batch's run (`parallel.run_nuts_sharded`
    runs a slice of the chains in each process)."""

    def __init__(self, gen, batch, dtype, device, rows=None):
        self.gen, self.batch, self.dtype, self.device = gen, batch, dtype, device
        self.keep = slice(*rows) if rows is not None else slice(None)

    def _rand(self, *shape):
        u = torch.rand((self.batch, *shape), generator=self.gen, dtype=self.dtype, device=self.device)
        return u[self.keep]

    def momentum(self, d):
        r = torch.randn((self.batch, d), generator=self.gen, dtype=self.dtype, device=self.device)
        return r[self.keep]

    def doubling(self, j):
        return self._rand(), self._rand(), self._rand(1 << j)

    def accept(self):
        return self._rand()


def fold_in(seed: int, index: int) -> int:
    """A seed made from (seed, index) alone, as `jax.random.fold_in` makes a
    key: the seed of run `index` of a bench, or of chain batch `index`."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint32)[0])


class BatchedLogDensity:
    """`q (C, d) -> (logp (C,), grad (C, d))` of a log-density of one flat
    position (d,): `torch.func.vmap` of `torch.func.grad_and_value`.
    `evals` counts the batched evaluations.

    `sequential=True` evaluates the chains one after another with ordinary
    autograd instead: for a log-density that runs collectives (a rows-sharded
    GP, `parallel`), which neither `vmap` nor `torch.func.grad` carries.
    `agree`, given, maps each evaluation's `(logp, grad)` to values that are
    bit-identical on every rank evaluating the same chains (`multichip`
    broadcasts them from the rows axis's rank 0), so that every decision
    the tree takes from them, and the collectives it issues, is the same on
    all those ranks."""

    def __init__(self, logdensity_fn, sequential=False, agree=None):
        if sequential:
            self._value_and_grad = _chain_by_chain(logdensity_fn)
        else:
            self._value_and_grad = torch.func.vmap(torch.func.grad_and_value(logdensity_fn))
        self._agree = agree
        self.evals = 0

    def __call__(self, q):
        self.evals += 1
        grad, logp = self._value_and_grad(q)
        if self._agree is not None:
            logp, grad = self._agree(logp, grad)
        return logp, grad


def _chain_by_chain(logdensity_fn):
    """`q (C, d) -> (grad, logp)`, one chain at a time by `torch.autograd`."""

    def value_and_grad(q):
        grads, logps = [], []
        for qi in q:
            with torch.enable_grad():
                qi = qi.detach().requires_grad_(True)
                lp = logdensity_fn(qi)
                (g,) = torch.autograd.grad(lp, qi)
            grads.append(g)
            logps.append(lp.detach())
        return torch.stack(grads), torch.stack(logps)

    return value_and_grad


class IntegratorState(NamedTuple):
    q: torch.Tensor  # position (C, d)
    r: torch.Tensor  # momentum (C, d)
    logp: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, d)


def _col(eps):
    """A per-chain step size (C,) as a column against (C, d)."""
    return eps[..., None] if torch.is_tensor(eps) and eps.dim() > 0 else eps


def _leapfrog(ld_and_grad, state: IntegratorState, eps, inv_mass):
    e = _col(eps)
    r = state.r + 0.5 * e * state.grad
    q = state.q + e * inv_mass * r
    logp, grad = ld_and_grad(q)
    r = r + 0.5 * e * grad
    return IntegratorState(q, r, logp, grad)


def _kinetic(r, inv_mass):
    return 0.5 * torch.sum(r * r * inv_mass, dim=-1)


def _energy(state: IntegratorState, inv_mass):
    return -state.logp + _kinetic(state.r, inv_mass)


def _velocity(r, inv_mass):
    return inv_mass * r


def _is_turning(rho, v_left, v_right):
    """Generalised U-turn criterion with velocity endpoints (Stan)."""
    return (torch.sum(rho * v_left, dim=-1) <= 0) | (torch.sum(rho * v_right, dim=-1) <= 0)


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _trailing_ones(n: int) -> int:
    """The number of trailing 1-bits of n: popcount((n ^ (n + 1)) >> 1)."""
    return _popcount((n ^ (n + 1)) >> 1)


def _where(mask, new, old):
    """`torch.where` per chain, over IntegratorStates, tuples or tensors."""
    if isinstance(new, tuple):
        return type(new)(*(_where(mask, a, b) for a, b in zip(new, old)))
    m = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
    return torch.where(m, new, old)


class NUTSInfo(NamedTuple):
    """Per chain and draw.  `num_evals` is the port's own: the batched
    log-density evaluations of the transition, the same for every chain
    (the leapfrogs of the longest trajectory among them)."""

    accept_prob: torch.Tensor
    diverging: torch.Tensor
    num_leaves: torch.Tensor
    tree_depth: torch.Tensor
    energy: torch.Tensor
    step_size: torch.Tensor
    num_evals: torch.Tensor


class _Subtree(NamedTuple):
    i: torch.Tensor  # leaves built, per chain
    z: IntegratorState  # the last leaf in the subtree's direction
    cum_rho: torch.Tensor  # momentum sum over the subtree's leaves
    prop: IntegratorState  # multinomial proposal within the subtree
    logw: torch.Tensor  # logsumexp of the leaves' weights
    sum_accept: torch.Tensor  # Σ min(1, e^{H0−H}), for adaptation
    turning: torch.Tensor
    diverging: torch.Tensor


def _build_subtree(ld_and_grad, z0, depth, eps, inv_mass, H0, max_depth, u_leaf, live0):
    """Up to 2^depth leapfrog leaves after z0 (eps (C,) carries the
    direction), for the chains in `live0`, with the U-turn checks against
    the checkpoint stack.  `u_leaf` (C, 2^depth) are the leaves' uniforms."""
    C, d = z0.q.shape
    dt, dev = z0.q.dtype, z0.q.device
    i_count = torch.zeros(C, dtype=torch.int64, device=dev)
    q, r, logp, grad = z0
    pq, plogp, pgrad = z0.q, z0.logp, z0.grad
    cum_rho = torch.zeros((C, d), dtype=dt, device=dev)
    logw = torch.full((C,), -math.inf, dtype=dt, device=dev)
    sum_accept = torch.zeros(C, dtype=dt, device=dev)
    turning = torch.zeros(C, dtype=torch.bool, device=dev)
    diverging = torch.zeros(C, dtype=torch.bool, device=dev)
    r_ck = torch.zeros((C, max_depth + 1, d), dtype=dt, device=dev)
    cum_ck = torch.zeros((C, max_depth + 1, d), dtype=dt, device=dev)
    # the leapfrog's factors, fixed over the subtree (the same products, in
    # the same order, as `_leapfrog`)
    e = eps[:, None]
    half_e = 0.5 * e
    e_inv_mass = e * inv_mass
    log_u = torch.log(u_leaf)
    for i in range(1 << depth):
        live = live0 & ~turning & ~diverging
        if not bool(live.any()):
            break
        lv = live[:, None]
        rn = r + half_e * grad
        qn = q + e_inv_mass * rn
        logpn, gradn = ld_and_grad(qn)
        rn = rn + half_e * gradn
        delta = (-logpn + _kinetic(rn, inv_mass)) - H0
        # a NaN energy (a failed factor at extreme hyperparameters) counts
        # as a divergence: ~(delta < thr) is True for NaN
        nan = torch.isnan(delta)
        div_leaf = ~(delta < _DIVERGENCE_THRESHOLD)
        logw_leaf = torch.where(nan, -math.inf, -delta)
        accept_leaf = torch.where(nan, 0.0, torch.clamp(torch.exp(-delta), max=1.0))
        logw_new = torch.logaddexp(logw, logw_leaf)
        take = (log_u[:, i] < (logw_leaf - logw_new)) & live
        cum_new = cum_rho + rn
        if i % 2 == 0:
            # even leaf: store a checkpoint at slot popcount(i)
            slot = _popcount(i)
            r_ck[:, slot] = torch.where(lv, rn, r_ck[:, slot])
            cum_ck[:, slot] = torch.where(lv, cum_new, cum_ck[:, slot])
        else:
            # odd leaf: U-turn checks against checkpoints lo..hi
            hi = _popcount(i) - 1
            lo = hi - _trailing_ones(i) + 1
            r_s = r_ck[:, lo:hi + 1]
            rho_blk = cum_new[:, None, :] - cum_ck[:, lo:hi + 1] + r_s
            v_s = _velocity(r_s, inv_mass[:, None, :])
            v_n = _velocity(rn, inv_mass)[:, None, :]
            turning = turning | (live & _is_turning(rho_blk, v_s, v_n).any(dim=1))
        tk = take[:, None]
        pq = torch.where(tk, qn, pq)
        plogp = torch.where(take, logpn, plogp)
        pgrad = torch.where(tk, gradn, pgrad)
        q = torch.where(lv, qn, q)
        r = torch.where(lv, rn, r)
        logp = torch.where(live, logpn, logp)
        grad = torch.where(lv, gradn, grad)
        cum_rho = torch.where(lv, cum_new, cum_rho)
        logw = torch.where(live, logw_new, logw)
        sum_accept = sum_accept + torch.where(live, accept_leaf, 0.0)
        diverging = diverging | (live & div_leaf)
        i_count = i_count + live
    return _Subtree(i_count, IntegratorState(q, r, logp, grad), cum_rho,
                    IntegratorState(pq, r, plogp, pgrad), logw, sum_accept, turning, diverging)


def _nuts_step(ld_and_grad, max_depth, draws, q, logp, grad, eps, inv_mass):
    C, d = q.shape
    dt, dev = q.dtype, q.device
    evals0 = ld_and_grad.evals
    r0 = draws.momentum(d) / torch.sqrt(inv_mass)
    z0 = IntegratorState(q, r0, logp, grad)
    H0 = _energy(z0, inv_mass)
    z_left = z_right = prop = z0
    rho = r0
    logw = torch.zeros(C, dtype=dt, device=dev)  # the root leaf's weight e^0
    sum_accept = torch.zeros(C, dtype=dt, device=dev)
    n_leaves = torch.zeros(C, dtype=torch.int64, device=dev)
    depth = torch.zeros(C, dtype=torch.int64, device=dev)
    turning = torch.zeros(C, dtype=torch.bool, device=dev)
    diverging = torch.zeros(C, dtype=torch.bool, device=dev)
    eps_t = torch.as_tensor(eps, dtype=dt, device=dev).expand(C)
    for j in range(max_depth):
        active = ~turning & ~diverging
        if not bool(active.any()):
            break
        u_dir, u_acc, u_leaf = draws.doubling(j)
        go_right = u_dir < 0.5
        direction = torch.where(go_right, 1.0, -1.0).to(dt)
        z_start = _where(go_right, z_right, z_left)
        sub = _build_subtree(ld_and_grad, z_start, j, direction * eps_t, inv_mass, H0,
                             max_depth, u_leaf, active)
        bad = sub.turning | sub.diverging
        # biased progressive sampling across the doubling
        accept_new = (torch.log(u_acc) < (sub.logw - logw)) & ~bad
        new_prop = _where(accept_new, sub.prop, prop)
        new_left = _where(go_right | bad, z_left, sub.z)
        new_right = _where(go_right & ~bad, sub.z, z_right)
        new_rho = rho + torch.where(bad[:, None], 0.0, sub.cum_rho)
        turning_full = _is_turning(new_rho, _velocity(new_left.r, inv_mass),
                                   _velocity(new_right.r, inv_mass))
        new_logw = torch.logaddexp(logw, torch.where(bad, -math.inf, sub.logw))
        prop = _where(active, new_prop, prop)
        z_left = _where(active, new_left, z_left)
        z_right = _where(active, new_right, z_right)
        rho = _where(active, new_rho, rho)
        logw = torch.where(active, new_logw, logw)
        sum_accept = torch.where(active, sum_accept + sub.sum_accept, sum_accept)
        n_leaves = torch.where(active, n_leaves + sub.i, n_leaves)
        depth = depth + active
        turning = torch.where(active, turning | bad | (~bad & turning_full), turning)
        diverging = torch.where(active, diverging | sub.diverging, diverging)
    evals = ld_and_grad.evals - evals0
    info = NUTSInfo(
        accept_prob=sum_accept / torch.clamp(n_leaves, min=1),
        diverging=diverging,
        num_leaves=n_leaves,
        tree_depth=depth,
        energy=-prop.logp,
        step_size=eps_t,
        num_evals=torch.full((C,), evals, dtype=torch.int64, device=dev),
    )
    return prop.q, prop.logp, prop.grad, info


def _draws(gen, q, chains):
    """The transition's draws for the chains `q` holds: all of them, or
    with `chains=(a, b, C)` chains [a, b) of a run of C."""
    if chains is None:
        return GeneratorDraws(gen, q.shape[0], q.dtype, q.device)
    a, b, C = chains
    return GeneratorDraws(gen, C, q.dtype, q.device, rows=(a, b))


def nuts_kernel(logdensity_fn, max_depth: int = 10, chains=None, sequential=False, agree=None):
    """A NUTS transition over a batch of chains:
    `step(gen, q, logp, grad, eps, inv_mass) -> (q', logp', grad', NUTSInfo)`
    with q, grad, inv_mass (C, d), logp and eps (C,), and `gen` a
    `torch.Generator` on their device.  `logdensity_fn` takes one flat
    position (d,); it is batched by `torch.func.vmap`, or evaluated chain
    by chain with `sequential=True` (`BatchedLogDensity`, also for
    `agree`).  `chains=(a, b, C)` says q holds chains [a, b) of a run of C
    (`_draws`)."""
    ld_and_grad = BatchedLogDensity(logdensity_fn, sequential, agree)

    def step(gen, q, logp, grad, eps, inv_mass):
        draws = _draws(gen, q, chains)
        return _nuts_step(ld_and_grad, max_depth, draws, q, logp, grad, eps, inv_mass)

    step.log_density = ld_and_grad
    return step


def _hmc_step(ld_and_grad, num_steps, draws, q, logp, grad, eps, inv_mass):
    C, d = q.shape
    dt, dev = q.dtype, q.device
    r0 = draws.momentum(d) / torch.sqrt(inv_mass)
    u_acc = draws.accept()
    z0 = IntegratorState(q, r0, logp, grad)
    H0 = _energy(z0, inv_mass)
    z = z0
    for _ in range(num_steps):
        z = _leapfrog(ld_and_grad, z, eps, inv_mass)
    H = _energy(z, inv_mass)
    accept_prob = torch.where(torch.isnan(H), 0.0, torch.clamp(torch.exp(H0 - H), max=1.0))
    accept = u_acc < accept_prob
    qn, logpn, gradn = (_where(accept, a, b) for a, b in ((z.q, q), (z.logp, logp), (z.grad, grad)))
    info = NUTSInfo(
        accept_prob=accept_prob,
        diverging=(H - H0) > _DIVERGENCE_THRESHOLD,
        num_leaves=torch.full((C,), num_steps, dtype=torch.int64, device=dev),
        tree_depth=torch.zeros(C, dtype=torch.int64, device=dev),
        energy=-logpn,
        step_size=torch.as_tensor(eps, dtype=dt, device=dev).expand(C),
        num_evals=torch.full((C,), num_steps, dtype=torch.int64, device=dev),
    )
    return qn, logpn, gradn, info


def hmc_kernel(logdensity_fn, num_steps: int = 32, chains=None):
    """Plain HMC over a batch of chains, with a fixed number of leapfrog
    steps and a Metropolis acceptance; the same signature as
    `nuts_kernel`'s step, and `chains` as there."""
    ld_and_grad = BatchedLogDensity(logdensity_fn)

    def step(gen, q, logp, grad, eps, inv_mass):
        draws = _draws(gen, q, chains)
        return _hmc_step(ld_and_grad, num_steps, draws, q, logp, grad, eps, inv_mass)

    step.log_density = ld_and_grad
    return step


# ---------------------------------------------------------------------------
# Adaptation (Stan's window adaptation), per chain
# ---------------------------------------------------------------------------


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    grad_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def _da_init(eps0):
    eps0 = torch.as_tensor(eps0)
    return DualAveragingState(
        log_eps=torch.log(eps0),
        log_eps_avg=torch.log(eps0),
        grad_avg=torch.zeros_like(eps0),
        t=torch.zeros_like(eps0),
        mu=torch.log(10.0 * eps0),
    )


def _da_update(s: DualAveragingState, accept_prob, target=0.8):
    gamma, t0, kappa = 0.05, 10.0, 0.75
    t = s.t + 1.0
    g = target - accept_prob
    grad_avg = (1.0 - 1.0 / (t + t0)) * s.grad_avg + g / (t + t0)
    log_eps = s.mu - torch.sqrt(t) / gamma * grad_avg
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * s.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, grad_avg, t, s.mu)


class WelfordState(NamedTuple):
    count: torch.Tensor  # (C,)
    mean: torch.Tensor  # (C, d)
    m2: torch.Tensor  # (C, d)


def _welford_init(batch, d, dtype, device):
    return WelfordState(torch.zeros(batch, dtype=dtype, device=device),
                        torch.zeros((*batch, d), dtype=dtype, device=device),
                        torch.zeros((*batch, d), dtype=dtype, device=device))


def _welford_update(s: WelfordState, x):
    count = s.count + 1.0
    delta = x - s.mean
    mean = s.mean + delta / count[..., None]
    m2 = s.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def _welford_variance(s: WelfordState):
    # Stan's regularised estimate
    count = s.count[..., None]
    var = s.m2 / torch.clamp(count - 1.0, min=1.0)
    shrink = count / (count + 5.0)
    return shrink * var + 1e-3 * (1.0 - shrink)


def window_adaptation_schedule(num_warmup, init_buffer=75, term_buffer=50, base_window=25):
    """Stan's three-phase warmup schedule: two bool tensors of length
    `num_warmup`, `in_window[i]` (collect the variance) and `window_end[i]`
    (reset the mass matrix after step i)."""
    in_window = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    if num_warmup < 20:
        return torch.from_numpy(in_window), torch.from_numpy(window_end)
    if init_buffer + term_buffer + base_window > num_warmup:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.1 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer
    start = init_buffer
    size = base_window
    while start < num_warmup - term_buffer:
        end = min(start + size, num_warmup - term_buffer)
        # the last window absorbs the remainder
        if end + 2 * size > num_warmup - term_buffer:
            end = num_warmup - term_buffer
        in_window[start:end] = True
        window_end[end - 1] = True
        start = end
        size *= 2
    return torch.from_numpy(in_window), torch.from_numpy(window_end)


def _find_reasonable_eps(ld_and_grad, q, logp, grad, inv_mass, r0):
    """Per chain, double or halve eps until the one-step acceptance
    probability crosses 0.5 (AdvancedHMC's `find_good_eps`), from the
    momentum `r0` (C, d)."""
    z0 = IntegratorState(q, r0, logp, grad)
    H0 = _energy(z0, inv_mass)

    def accept_prob(eps):
        z = _leapfrog(ld_and_grad, z0, eps, inv_mass)
        return torch.exp(torch.clamp(H0 - _energy(z, inv_mass), max=0.0))

    eps = torch.ones(q.shape[0], dtype=q.dtype, device=q.device)
    p = accept_prob(eps)
    going_up = p > 0.5
    it = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    while True:
        crossed = torch.where(going_up, p <= 0.5, p >= 0.5)
        more = ~crossed & (it < 50) & (eps > 1e-10) & (eps < 1e7)
        if not bool(more.any()):
            break
        eps_new = torch.where(going_up, eps * 2.0, eps * 0.5)
        p_new = accept_prob(eps_new)
        eps = torch.where(more, eps_new, eps)
        p = torch.where(more, p_new, p)
        it = it + more
    # step back once on the way up, to end on the acceptable side
    return torch.where(going_up, eps * 0.5, eps)


#: N at and above which `precision='auto'` pins 'highest' GEMMs for an f32
#: log-density (reference `inference/hmc.py:480-487`): on its TPU, exact-GP
#: NUTS at N = 4096 f32 degraded silently at HIGH (bf16_3x; R̂ 1.4–2.2, no
#: divergences), its signal-variance gradient being cancellation noise.  On
#: the card 'high' is 3xTF32; `accuracy_probe` reads that gradient there.
AUTO_HIGHEST_MIN_N = 4096


@contextmanager
def _tf32_off(scope):
    """`scope`, with the TF32 switch held off for the run and restored on
    any exit (`ops/blocked_cholesky.py:_tf32`): 'highest' is full fp32 in
    every matmul, also where a caller has turned TF32 on."""
    from stheno_tpu_torch.ops import blocked_cholesky as _bc

    with _bc._tf32(False), scope:
        yield


def _precision_policy(precision, flat_logdensity, q0):
    """Resolve a `precision` argument into (context manager, resolved
    precision or None), as the reference's `_precision_policy`:

    - None: no scope (the caller manages the precision);
    - 'auto': find what the log-density factorises, by evaluating it once at
      `q0` (the first chain's initial position) under `torch.no_grad()`
      inside `ops.chol.record_chol_sizes()`, where the reference traces it
      with `jax.eval_shape`.  If it factorises an f32 covariance of N ≥
      `AUTO_HIGHEST_MIN_N` and the active GEMM precision is below
      'highest', scope 'highest' over the run and warn once.  Otherwise, or
      when the evaluation raises, no scope.  At 'highest' already nothing is
      evaluated: the answer is no scope whatever the sizes;
    - anything else: normalised (`config.gemm_precision`'s names, any case,
      or a `config.Precision`) and scoped as given.

    Wherever the run is at 'highest' by this policy (explicit, 'auto' at
    'highest' already, or pinned by 'auto'), the scope also holds the TF32
    switch off (`_tf32_off`), so a caller's TF32 does not reach the run.
    """
    from stheno_tpu_torch import config as _cfg
    from stheno_tpu_torch.ops import blocked_cholesky as _bc
    from stheno_tpu_torch.ops import chol as _chol

    if precision is None:
        return nullcontext(), None
    if precision != "auto":
        p = _cfg._norm_precision(precision)
        scope = _cfg.gemm_precision(p)
        return (_tf32_off(scope) if p is _cfg.Precision.HIGHEST else scope), p
    if _bc._active_prec() is _cfg.Precision.HIGHEST:
        return _tf32_off(nullcontext()), None
    try:
        with torch.no_grad(), _chol.record_chol_sizes() as sizes:
            flat_logdensity(q0)
    except Exception:
        # a log-density that cannot be evaluated on its own here: no policy
        return nullcontext(), None
    big_f32 = [n for n, dt in sizes if n >= AUTO_HIGHEST_MIN_N and dt == torch.float32]
    if not big_f32:
        return nullcontext(), None
    warnings.warn(
        f"precision='auto': the log-density factorises an N={max(big_f32)} float32 "
        f"covariance, so all GEMMs in this run are pinned to 'highest' precision (below it "
        f"the cancellation-dominated variance gradient can degrade mixing silently at "
        f"N>={AUTO_HIGHEST_MIN_N}).  Pass precision=None to opt out, or an explicit "
        f"precision to choose.",
        stacklevel=3,
    )
    return _tf32_off(_cfg.gemm_precision(_cfg.Precision.HIGHEST)), _cfg.Precision.HIGHEST


def _check_mixing(qs, dt, resolved_prec, num_chains, num_samples):
    """Warn when the chains have not mixed (max split-R̂ above
    `RHAT_WARN_THRESHOLD`), with a hint when an f32 run's GEMMs ran below
    'highest'."""
    if num_chains < 2 or num_samples < 8:
        return
    rhat = float(torch.max(potential_scale_reduction(qs)))
    if not math.isfinite(rhat) or rhat <= RHAT_WARN_THRESHOLD:
        return
    from stheno_tpu_torch.config import Precision
    from stheno_tpu_torch.ops import blocked_cholesky as _bc

    prec = resolved_prec if resolved_prec is not None else _bc._active_prec()
    hint = ""
    if dt == torch.float32 and prec is not Precision.HIGHEST:
        hint = ("  This run's GEMMs ran below 'highest' precision; exact-GP posteriors at "
                "N>~4096 f32 may degrade silently there (cancellation-noise gradients) - "
                "re-run under `with stheno_tpu_torch.config.gemm_precision('highest')` or "
                "leave precision='auto'.")
    warnings.warn(
        f"NUTS chains have not mixed: max split-R-hat = {rhat:.3f} > {RHAT_WARN_THRESHOLD}.  "
        f"Treat these draws as unconverged (more warmup / reparametrise / check gradients).{hint}",
        stacklevel=3,
    )


class ChainState(NamedTuple):
    """Resumable per-chain sampler state (checkpointable)."""

    q: torch.Tensor  # (C, d)
    logp: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, d)
    eps: torch.Tensor  # (C,) adapted step sizes
    inv_mass: torch.Tensor  # (C, d)


class WarmupState(NamedTuple):
    """Resumable mid-warmup state: the positions and the whole adaptation
    state (dual averaging, Welford, the current mass matrix)."""

    q: torch.Tensor  # (C, d)
    logp: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, d)
    da: DualAveragingState  # (C,) leaves
    wf: WelfordState
    inv_mass: torch.Tensor  # (C, d)


def _kernel(logdensity_fn, kernel, max_depth, num_hmc_steps, chains=None):
    if kernel == "nuts":
        return nuts_kernel(logdensity_fn, max_depth=max_depth, chains=chains)
    if kernel == "hmc":
        return hmc_kernel(logdensity_fn, num_steps=num_hmc_steps, chains=chains)
    raise ValueError(f"kernel must be 'nuts' or 'hmc', got {kernel!r}")


def _warmup_init(seed, step_fn, flat0, num_chains, init_jitter, chains=None):
    """Chains jittered around `flat0` (chain 0 exactly at it), their
    log-density, and a step size found per chain.  With `chains=(a, b, C)`
    the whole run's numbers are drawn and chains [a, b) kept."""
    a, b, C = chains if chains is not None else (0, num_chains, num_chains)
    d = flat0.shape[0]
    dt, dev = flat0.dtype, flat0.device
    gen = generator(seed, _INIT, 0, dev)
    jitter = torch.randn((C, d), generator=gen, dtype=dt, device=dev)
    jitter[0] = 0.0
    q0 = (flat0[None, :] + init_jitter * jitter)[a:b]
    ld_and_grad = step_fn.log_density
    logp0, grad0 = ld_and_grad(q0)
    inv_mass0 = torch.ones((b - a, d), dtype=dt, device=dev)
    r0 = torch.randn((C, d), generator=gen, dtype=dt, device=dev)[a:b] / torch.sqrt(inv_mass0)
    eps0 = _find_reasonable_eps(ld_and_grad, q0, logp0, grad0, inv_mass0, r0)
    return WarmupState(q0, logp0, grad0, _da_init(eps0), _welford_init((b - a,), d, dt, dev),
                       inv_mass0)


def _warm_iteration(step_fn, target_accept, st: WarmupState, gen, in_window, window_end):
    """One Stan-window warmup iteration, for every chain."""
    q, logp, grad, info = step_fn(gen, st.q, st.logp, st.grad, torch.exp(st.da.log_eps), st.inv_mass)
    da = _da_update(st.da, info.accept_prob, target_accept)
    wf = _welford_update(st.wf, q) if in_window else st.wf
    inv_mass = st.inv_mass
    if window_end:
        # at a window's end: the new mass matrix, and the step size search anew
        inv_mass = _welford_variance(wf)
        da = _da_init(torch.exp(da.log_eps_avg))
        wf = _welford_init(q.shape[:1], q.shape[1], q.dtype, q.device)
    return WarmupState(q, logp, grad, da, wf, inv_mass)


def _warm_range(seed, step_fn, target_accept, st, num_warmup, a, b):
    in_window, window_end = window_adaptation_schedule(num_warmup)
    for i in range(a, min(b, num_warmup)):
        gen = generator(seed, _WARMUP, i, st.q.device)
        st = _warm_iteration(step_fn, target_accept, st, gen, bool(in_window[i]), bool(window_end[i]))
    return st


def nuts_warmup(
    seed,
    logdensity_fn,
    init_position,
    num_warmup,
    num_chains=1,
    max_depth=10,
    target_accept=0.8,
    kernel="nuts",
    num_hmc_steps=32,
    init_jitter=1.0,
    segment=None,
    state: "WarmupState | None" = None,
    precision="auto",
):
    """Stan-window warmup of `num_chains` chains, optionally in resumable
    segments.  Returns the `WarmupState`; `warmup_result(state)` gives the
    `ChainState` for `run_nuts(..., resume_state=...)`.

    `segment=(a, b)` runs iterations [a, b) of the fixed `num_warmup`-long
    schedule, from `state` (required when a > 0).  A segment that
    overshoots the schedule (b > num_warmup) runs the iterations past it as
    no-ops, so the last segment may be issued at full length.  Given the
    same `seed` (the one passed to `run_nuts` too), any segmentation, none
    included, gives the same adaptation as `run_nuts`'s own warmup, bit for
    bit on one device: iteration i always draws from the generator of
    (seed, warmup, i).

    `precision`: the GEMM-precision policy of the whole warmup: 'auto'
    (default: 'highest' when the log-density factorises a large f32
    covariance and the active precision is below it, see
    `_precision_policy`), None (no scope), or an explicit precision
    ('default' | 'high' | 'highest' or a `config.Precision`).  Pass the same
    value to the matching `run_nuts`.
    """
    if num_warmup < 1:
        # a run without warmup is `run_nuts(..., resume_state=...)`'s job
        raise ValueError(f"nuts_warmup requires num_warmup >= 1, got {num_warmup}")
    a, b = segment if segment is not None else (0, num_warmup)
    a, b = int(a), int(b)
    if not 0 <= a < min(b, num_warmup):
        raise ValueError(f"segment {segment} outside [0, {num_warmup})")
    if a > 0 and state is None:
        raise ValueError("resuming a warmup segment (a > 0) requires `state`")
    flat0, unravel = ravel_pytree(init_position)
    flat_logdensity = lambda qf: logdensity_fn(unravel(qf))  # noqa: E731
    step_fn = _kernel(flat_logdensity, kernel, max_depth, num_hmc_steps)
    prec_ctx, _ = _precision_policy(precision, flat_logdensity, flat0)
    with prec_ctx, torch.no_grad():
        if a == 0:
            state = _warmup_init(seed, step_fn, flat0, num_chains, init_jitter)
        return _warm_range(seed, step_fn, target_accept, state, num_warmup, a, b)


def warmup_result(state: WarmupState) -> ChainState:
    """The adapted `ChainState` (eps = the averaged dual-averaging step
    size) for `run_nuts(..., resume_state=...)`."""
    return ChainState(q=state.q, logp=state.logp, grad=state.grad,
                      eps=torch.exp(state.da.log_eps_avg), inv_mass=state.inv_mass)


def run_nuts(
    seed,
    logdensity_fn,
    init_position,
    num_warmup=500,
    num_samples=500,
    num_chains=1,
    max_depth=10,
    target_accept=0.8,
    kernel="nuts",
    num_hmc_steps=32,
    init_jitter=1.0,
    return_state=False,
    resume_state: "ChainState | None" = None,
    sample_offset=0,
    precision="auto",
    check_rhat=True,
    chains=None,
    gather=None,
):
    """Warmup and sampling of `num_chains` chains, batched.

    `init_position` is a flat vector or a tree of tensors (dicts, lists,
    tuples; dict keys in sorted order); chains start at it jittered by
    N(0, init_jitter²), chain 0 exactly at it.  Returns `(samples, info)`:
    `samples` (num_chains, num_samples, d), or the tree with leaves of
    (num_chains, num_samples, ...); `info` a `NUTSInfo` of
    (num_chains, num_samples) tensors.  With `return_state=True` also the
    final `ChainState`.

    Resume: `resume_state` skips warmup and samples on from it.  Draw i
    takes the generator of (seed, sample, sample_offset + i), so a run
    resumed with the same `seed` and `sample_offset` = the draws already
    taken gives the uninterrupted run's draws bit for bit on one device.

    `precision` as in `nuts_warmup`.  `check_rhat` warns when the max
    split-R̂ over the flat coordinates exceeds `RHAT_WARN_THRESHOLD`, with a
    precision hint when an f32 run's GEMMs ran below 'highest'.

    `chains=(a, b, num_chains)` runs only chains [a, b) of the run, with the
    numbers they draw in the whole run; `gather` then maps this process's
    draws to every chain's for the R̂ check (`parallel.run_nuts_sharded`).
    """
    flat0, unravel = ravel_pytree(init_position)
    flat_logdensity = lambda qf: logdensity_fn(unravel(qf))  # noqa: E731
    step_fn = _kernel(flat_logdensity, kernel, max_depth, num_hmc_steps, chains)
    dev = flat0.device
    prec_ctx, resolved_prec = _precision_policy(precision, flat_logdensity, flat0)
    with prec_ctx, torch.no_grad():
        if resume_state is None:
            st = _warmup_init(seed, step_fn, flat0, num_chains, init_jitter, chains)
            st = _warm_range(seed, step_fn, target_accept, st, num_warmup, 0, num_warmup)
            resume_state = warmup_result(st)
        q, logp, grad, eps, inv_mass = (t.to(dev) for t in resume_state)
        C, d = q.shape
        qs = torch.empty((C, num_samples, d), dtype=q.dtype, device=dev)
        infos = []
        for i in range(num_samples):
            gen = generator(seed, _SAMPLE, sample_offset + i, dev)
            q, logp, grad, info = step_fn(gen, q, logp, grad, eps, inv_mass)
            qs[:, i] = q
            infos.append(info)
        info = NUTSInfo(*(torch.stack(field, dim=1) for field in zip(*infos))) if infos else None
    if check_rhat:
        if chains is None:
            _check_mixing(qs, flat0.dtype, resolved_prec, C, num_samples)
        else:
            _check_mixing(gather(qs), flat0.dtype, resolved_prec, chains[2], num_samples)
    samples = unravel(qs)
    if return_state:
        return samples, info, ChainState(q, logp, grad, eps, inv_mass)
    return samples, info

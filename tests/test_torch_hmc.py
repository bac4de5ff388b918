"""The port's HMC and NUTS (`stheno_tpu_torch.inference.hmc`, batched over
a leading chain axis) against the JAX package's (one chain, `jax.vmap`).

- The deterministic core equals the reference on the same inputs, to rtol
  1e-12 in f64: the leapfrog, kinetic energy, energy, velocity and U-turn
  criterion, the trailing-ones count, dual averaging, Welford, the window
  schedule (exactly) and `_find_reasonable_eps` given the same momentum.
- Given the reference's own random numbers (its per-chain keys split as it
  splits them), a batched NUTS or HMC transition equals `jax.vmap` of the
  reference's: positions, log-densities and gradients to rtol 1e-12, the
  trees' sizes, depths and divergences exactly.
- Resumed sampling equals the uninterrupted run bit for bit, and so does a
  segmented warmup, an overshooting last segment included; `num_warmup=0`
  raises; the split-R̂ warning fires on unmixed chains; the `precision`
  values behave as specified.

Sampling from states the reference adapted is in `test_torch_hmc_states.py`;
the port's counterparts of the reference's statistical NUTS and HMC tests
are in `test_torch_nuts.py` and `test_torch_nuts_targets.py`."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stheno_tpu.inference import hmc as jh
from stheno_tpu_torch.inference import (
    ChainState,
    load_checkpoint,
    nuts_warmup,
    run_nuts,
    save_checkpoint,
    warmup_result,
)
from stheno_tpu_torch.inference import hmc as th
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

RTOL = 1e-12
A = np.array([[2.0, 0.3, 0.0], [0.3, 1.0, -0.2], [0.0, -0.2, 0.5]])


def _j_logp(q):
    return -0.5 * q @ jnp.asarray(A) @ q - 0.1 * jnp.sum(q**4)


def _t_logp(q):
    return -0.5 * q @ torch.as_tensor(A) @ q - 0.1 * torch.sum(q**4)


def _batch(seed, c=4, d=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(c, d)), rng.normal(size=(c, d)), rng.uniform(0.05, 0.6, size=c),
            rng.uniform(0.5, 2.0, size=(c, d)))


def test_leapfrog_and_energies_equal_the_reference():
    q, r, eps, inv_mass = _batch(0)
    j_vg = jax.value_and_grad(_j_logp)
    logp, grad = jax.vmap(j_vg)(jnp.asarray(q))
    j_state = jh.IntegratorState(jnp.asarray(q), jnp.asarray(r), logp, grad)
    j_out = jax.vmap(lambda s, e, m: jh._leapfrog(j_vg, s, e, m))(
        j_state, jnp.asarray(eps), jnp.asarray(inv_mass))
    t_state = th.IntegratorState(*(torch.as_tensor(np.array(a)) for a in j_state))
    t_out = th._leapfrog(th.BatchedLogDensity(_t_logp), t_state, torch.as_tensor(eps),
                         torch.as_tensor(inv_mass))
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    m = torch.as_tensor(inv_mass)
    np.testing.assert_allclose(th._kinetic(t_out.r, m).numpy(),
                               np.asarray(jax.vmap(jh._kinetic)(j_out.r, jnp.asarray(inv_mass))), rtol=RTOL)
    np.testing.assert_allclose(th._energy(t_out, m).numpy(),
                               np.asarray(jax.vmap(jh._energy)(j_out, jnp.asarray(inv_mass))), rtol=RTOL)
    np.testing.assert_allclose(th._velocity(t_out.r, m).numpy(),
                               np.asarray(jh._velocity(j_out.r, jnp.asarray(inv_mass))), rtol=RTOL)


def test_u_turn_criterion_and_trailing_ones_equal_the_reference():
    rng = np.random.default_rng(1)
    rho, vl, vr = (rng.normal(size=(200, 3)) for _ in range(3))
    ref = jax.vmap(jh._is_turning)(jnp.asarray(rho), jnp.asarray(vl), jnp.asarray(vr))
    got = th._is_turning(*(torch.as_tensor(a) for a in (rho, vl, vr)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    n = np.arange(512, dtype=np.int32)
    ref = np.asarray(jh._trailing_ones(jnp.asarray(n)))
    np.testing.assert_array_equal([th._trailing_ones(int(i)) for i in n], ref)


def test_dual_averaging_and_welford_equal_the_reference():
    rng = np.random.default_rng(2)
    eps0 = rng.uniform(0.1, 1.0, size=4)
    j_da, t_da = jh._da_init(jnp.asarray(eps0)), th._da_init(torch.as_tensor(eps0))
    for _ in range(60):
        acc = rng.uniform(size=4)
        j_da = jh._da_update(j_da, jnp.asarray(acc), 0.8)
        t_da = th._da_update(t_da, torch.as_tensor(acc), 0.8)
    for a, b in zip(t_da, j_da):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    j_wf = jax.vmap(lambda _: jh._welford_init(3, jnp.float64))(jnp.arange(4))
    t_wf = th._welford_init((4,), 3, torch.float64, "cpu")
    for _ in range(37):
        x = rng.normal(size=(4, 3))
        j_wf = jax.vmap(jh._welford_update)(j_wf, jnp.asarray(x))
        t_wf = th._welford_update(t_wf, torch.as_tensor(x))
    for a, b in zip(t_wf, j_wf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    np.testing.assert_allclose(th._welford_variance(t_wf).numpy(),
                               np.asarray(jax.vmap(jh._welford_variance)(j_wf)), rtol=RTOL)


@pytest.mark.parametrize("num_warmup", [5, 19, 20, 50, 99, 150, 300, 500, 1000, 1234])
def test_window_schedule_equals_the_reference(num_warmup):
    for t, j in zip(th.window_adaptation_schedule(num_warmup), jh.window_adaptation_schedule(num_warmup)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_find_reasonable_eps_equals_the_reference_given_the_same_momentum():
    q, _, _, inv_mass = _batch(3, c=5)
    q = q * np.array([[0.1], [1.0], [3.0], [0.0], [10.0]])  # from flat to steep
    keys = jax.random.split(jax.random.PRNGKey(4), 5)
    j_vg = jax.value_and_grad(_j_logp)
    ref, r0 = [], []
    for c in range(5):
        qc, mc = jnp.asarray(q[c]), jnp.asarray(inv_mass[c])
        logp, grad = j_vg(qc)
        ref.append(float(jh._find_reasonable_eps(j_vg, keys[c], qc, logp, grad, mc)))
        # the momentum the reference draws inside
        r0.append(np.asarray(jax.random.normal(keys[c], qc.shape, qc.dtype) / jnp.sqrt(mc)))
    ld = th.BatchedLogDensity(_t_logp)
    tq, tm = torch.as_tensor(q), torch.as_tensor(inv_mass)
    logp, grad = ld(tq)
    got = th._find_reasonable_eps(ld, tq, logp, grad, tm, torch.as_tensor(np.stack(r0)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL)


class _JaxDraws:
    """The reference's random numbers of one transition for C chains, from
    its per-chain keys, split as `nuts_kernel`/`hmc_kernel` split them;
    the same interface as the port's `GeneratorDraws`."""

    def __init__(self, keys):
        self.mom, self.rest = zip(*(jax.random.split(k) for k in keys))
        self.rest = list(self.rest)

    @staticmethod
    def _t(values):
        return torch.as_tensor(np.asarray(values, dtype=np.float64))

    def momentum(self, d):
        return self._t([np.asarray(jax.random.normal(k, (d,), jnp.float64)) for k in self.mom])

    def doubling(self, j):
        u_dir, u_acc, u_leaf = [], [], []
        for c, key in enumerate(self.rest):
            key, k_dir, k_sub, k_acc = jax.random.split(key, 4)
            self.rest[c] = key
            # the reference goes right where bernoulli(k_dir) holds
            u_dir.append(0.25 if bool(jax.random.bernoulli(k_dir)) else 0.75)
            leaves = []
            for _ in range(1 << j):
                k_sub, sub = jax.random.split(k_sub)
                leaves.append(float(jax.random.uniform(sub, dtype=jnp.float64)))
            u_leaf.append(leaves)
            u_acc.append(float(jax.random.uniform(k_acc, dtype=jnp.float64)))
        return self._t(u_dir), self._t(u_acc), self._t(u_leaf)

    def accept(self):
        return self._t([float(jax.random.uniform(k, dtype=jnp.float64)) for k in self.rest])


@pytest.mark.parametrize("kernel", ["nuts", "hmc"])
def test_transition_equals_the_reference_given_its_draws(kernel):
    """Six chains, five transitions each, on a quartic target, from step
    sizes small to divergent (ε = 3 diverges at once), under max_depth 6."""
    C, d, max_depth, num_steps = 6, 3, 6, 5
    rng = np.random.default_rng(6)
    q = rng.normal(size=(C, d))
    eps = np.array([0.05, 0.2, 0.4, 0.7, 1.0, 3.0])
    inv_mass = rng.uniform(0.5, 2.0, size=(C, d))
    if kernel == "nuts":
        j_step = jh.nuts_kernel(_j_logp, max_depth=max_depth)
    else:
        j_step = jh.hmc_kernel(_j_logp, num_steps=num_steps)
    j_vstep = jax.jit(jax.vmap(j_step))
    logp, grad = jax.vmap(jax.value_and_grad(_j_logp))(jnp.asarray(q))
    j_state = (jnp.asarray(q), logp, grad)
    ld = th.BatchedLogDensity(_t_logp)
    t_state = tuple(torch.as_tensor(np.array(a)) for a in j_state)
    te, tm = torch.as_tensor(eps), torch.as_tensor(inv_mass)
    for t in range(5):
        keys = jax.random.split(jax.random.PRNGKey(100 + t), C)
        *j_state, j_info = j_vstep(keys, *j_state, jnp.asarray(eps), jnp.asarray(inv_mass))
        if kernel == "nuts":
            *t_state, t_info = th._nuts_step(ld, max_depth, _JaxDraws(keys), *t_state, te, tm)
        else:
            *t_state, t_info = th._hmc_step(ld, num_steps, _JaxDraws(keys), *t_state, te, tm)
        for a, b in zip(t_state, j_state):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-13)
        for name in ("diverging", "num_leaves", "tree_depth"):
            np.testing.assert_array_equal(getattr(t_info, name).numpy(), np.asarray(getattr(j_info, name)),
                                          err_msg=name)
        for name in ("accept_prob", "energy", "step_size"):
            np.testing.assert_allclose(getattr(t_info, name).numpy(), np.asarray(getattr(j_info, name)),
                                       rtol=RTOL, atol=1e-13, err_msg=name)
    assert bool(t_info.diverging[-1]) and not bool(t_info.diverging[0])


def _std_normal(q):
    return -0.5 * torch.sum(q**2)


def test_resume_equals_uninterrupted(tmp_path):
    """warmup → checkpoint → resume with `sample_offset` reproduces the
    uninterrupted run bit for bit (the same seed)."""
    S1, S2, z = 60, 40, torch.zeros(3, dtype=torch.float64)
    full, _ = run_nuts(3, _std_normal, z, num_warmup=100, num_samples=S1 + S2, num_chains=2)
    seg1, _, state = run_nuts(3, _std_normal, z, num_warmup=100, num_samples=S1, num_chains=2,
                              return_state=True)
    assert state.q.shape == (2, 3) and state.eps.shape == (2,)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state, step=S1)
    restored = load_checkpoint(path, state)
    seg2, _ = run_nuts(3, _std_normal, z, num_samples=S2, num_chains=2,
                       resume_state=ChainState(*restored), sample_offset=S1)
    np.testing.assert_array_equal(seg1.numpy(), full[:, :S1].numpy())
    np.testing.assert_array_equal(seg2.numpy(), full[:, S1:].numpy())


def test_segmented_warmup_equals_fused():
    """`nuts_warmup` whole, in two segments, and in segments whose last one
    overshoots the schedule, reproduces `run_nuts`'s own warmup bit for
    bit: sampling from each `warmup_result` equals the fused run."""

    def logp(q):
        return -0.5 * torch.sum(q**2) - 0.1 * torch.sum(q**4)

    W, S, C, z = 50, 20, 3, torch.zeros(2, dtype=torch.float64)
    full, _ = run_nuts(5, logp, z, num_warmup=W, num_samples=S, num_chains=C, check_rhat=False)

    def sample(state):
        s, _ = run_nuts(5, logp, z, num_samples=S, num_chains=C, resume_state=warmup_result(state),
                        check_rhat=False)
        return s.numpy()

    st1 = nuts_warmup(5, logp, z, num_warmup=W, num_chains=C)
    np.testing.assert_array_equal(sample(st1), full.numpy())
    sta = nuts_warmup(5, logp, z, num_warmup=W, num_chains=C, segment=(0, 30))
    stb = nuts_warmup(5, logp, z, num_warmup=W, num_chains=C, segment=(30, W), state=sta)
    np.testing.assert_array_equal(sample(stb), full.numpy())
    st = nuts_warmup(5, logp, z, num_warmup=W, num_chains=C, segment=(0, 20))
    for a in (20, 40):  # the last segment, (40, 60), overshoots W = 50
        st = nuts_warmup(5, logp, z, num_warmup=W, num_chains=C, segment=(a, a + 20), state=st)
    np.testing.assert_array_equal(sample(st), full.numpy())
    for a, b in zip(st, stb):  # the adaptation states agree, leaf for leaf
        for x, y in zip(*(v if isinstance(v, tuple) else (v,) for v in (a, b))):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    # misuse raises: a later segment without a state, a segment outside
    with pytest.raises(ValueError):
        nuts_warmup(5, logp, z, num_warmup=W, segment=(10, 20))
    with pytest.raises(ValueError):
        nuts_warmup(5, logp, z, num_warmup=W, segment=(W, W + 10), state=st)


def test_num_warmup_zero_raises():
    with pytest.raises(ValueError, match="num_warmup >= 1"):
        nuts_warmup(0, _std_normal, torch.zeros(2), num_warmup=0)


def test_rhat_warning_fires_on_unmixed_chains():
    """Two chains held far apart by a tiny step size have not mixed."""
    q = torch.tensor([[-4.0, -4.0], [4.0, 4.0]], dtype=torch.float64)
    ld = th.BatchedLogDensity(_std_normal)
    logp, grad = ld(q)
    state = ChainState(q, logp, grad, torch.full((2,), 1e-3, dtype=torch.float64),
                       torch.ones_like(q))
    with pytest.warns(UserWarning, match="have not mixed"):
        run_nuts(0, _std_normal, torch.zeros(2, dtype=torch.float64), num_samples=20,
                 num_chains=2, resume_state=state, max_depth=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        run_nuts(0, _std_normal, torch.zeros(2, dtype=torch.float64), num_samples=20,
                 num_chains=2, resume_state=state, max_depth=3, check_rhat=False)


def test_precision_values_behave_as_specified():
    """`precision` as the reference's: an explicit one (any case) is scoped
    over the run as the GEMM precision, None scopes nothing, 'auto' pins
    'highest' only for a large f32 factor (none here), and an unknown name
    raises KeyError.  A run at 'highest' ('auto' at the default included)
    holds the TF32 switch off even where the caller has it on, and restores
    it after the run."""
    from stheno_tpu_torch import config
    from stheno_tpu_torch.ops import blocked_cholesky as bc

    seen = []

    def logp(q):
        seen.append((bc._active_prec(), torch.backends.cuda.matmul.allow_tf32))
        return _std_normal(q)

    z = torch.zeros(2, dtype=torch.float64)
    P = config.Precision
    for precision, want in (("auto", P.HIGHEST), ("highest", P.HIGHEST), ("HIGH", P.HIGH),
                            ("default", P.DEFAULT), (None, P.HIGHEST)):
        seen.clear()
        run_nuts(0, logp, z, num_warmup=3, num_samples=2, num_chains=2, precision=precision)
        assert seen and all(p is want and not tf32 for p, tf32 in seen), precision
    with config.gemm_precision("high"):
        for precision in (None, "auto"):  # left alone: nothing factorised here
            seen.clear()
            nuts_warmup(0, logp, z, num_warmup=3, precision=precision)
            assert seen and all(p is P.HIGH for p, _ in seen), precision
    assert bc._active_prec() is P.HIGHEST
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True  # TF32 on, as a caller may have it
        for precision in ("auto", "highest"):
            seen.clear()
            run_nuts(0, logp, z, num_warmup=3, num_samples=2, num_chains=2, precision=precision)
            assert seen and not any(tf32 for _, tf32 in seen), precision  # fp32 for the run
            assert torch.backends.cuda.matmul.allow_tf32  # and restored after it
        for precision in (None, "high"):  # left alone
            seen.clear()
            run_nuts(0, logp, z, num_warmup=3, num_samples=2, num_chains=2, precision=precision)
            assert seen and all(tf32 for _, tf32 in seen), precision
        with pytest.raises(ZeroDivisionError):  # restored after an exception in the run too
            run_nuts(0, lambda q: 1 / 0, z, num_warmup=3, num_samples=2, num_chains=2,
                     precision="highest")
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    for bad in ("bf16_3x", "tf32"):
        with pytest.raises(KeyError):
            nuts_warmup(0, logp, z, num_warmup=3, precision=bad)

"""The GEMM-precision tier of the port (`config.gemm_precision`,
`bwd_precision`, `snapshot`, the deprecated setters, `ops.blocked_cholesky._mm`
and the TF32 split's plain version, `ops.chol.record_chol_sizes`, the
samplers' `precision` policy) against `stheno_tpu` on the CPU.

On the CPU the precisions write out TF32's rounding (no tensor cores, no
flag touched): 'default' multiplies operands rounded to TF32, 'high' the
split parts (each lo rounded once more).  'highest', and any f64 operand,
is `a @ b` itself, bit for bit."""

import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import stheno_tpu
import stheno_tpu_torch as stt
from stheno_tpu_torch import entry
from stheno_tpu.inference import hmc as jh
from stheno_tpu.ops import blocked_cholesky as jbc
from stheno_tpu.ops import chol as jchol
from stheno_tpu_torch import config as tcfg
from stheno_tpu_torch.cuda import tf32_split as ts
from stheno_tpu_torch.inference import hmc as th
from stheno_tpu_torch.ops import blocked_cholesky as tbc
from stheno_tpu_torch.ops import chol as tchol
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_dist_ranks import spawn

PRECISIONS = ("highest", "high", "default")
#: the products against f64, normalised by max(|A||B|) (the card's
#: `chip_smoke.py` phase 14 holds the same): 'high' to 4× fp32's own error,
#: 'default' (one TF32 pass, about 2⁻¹¹ an operand) to 1e-3
HIGH_OVER_FP32, DEFAULT_TOL = 4.0, 1e-3


def _psd(seed, n, dtype=np.float64):
    A = np.random.default_rng(seed).normal(size=(n, n))
    return (A @ A.T / n + np.eye(n)).astype(dtype)


# ---- the API against stheno_tpu.config ----------------------------------------


def test_names_exist_in_both_packages():
    for name in ("gemm_precision", "bwd_precision", "snapshot", "default_float", "scoped",
                 "bwd_params", "chol_backend", "_norm_precision"):
        assert hasattr(stheno_tpu.config, name) and hasattr(tcfg, name), name
    for name in ("set_gemm_precision", "set_bwd_precision", "set_bwd_params", "set_base_cholesky",
                 "set_base_tri_inv", "_active_prec", "_active_bwd_prec", "_mm", "_PREC",
                 "_BWD_PREC"):
        assert hasattr(jbc, name) and hasattr(tbc, name), name
    assert hasattr(jchol, "record_chol_sizes") and hasattr(tchol, "record_chol_sizes")
    assert jh.AUTO_HIGHEST_MIN_N == th.AUTO_HIGHEST_MIN_N == 4096
    assert hasattr(jh, "_precision_policy") and hasattr(th, "_precision_policy")


@pytest.mark.parametrize("text", ["default", "high", "highest", "HIGH", "High", "hIgHeSt"])
def test_names_in_any_case_normalise_as_the_reference(text):
    assert tcfg._norm_precision(text).name == stheno_tpu.config._norm_precision(text).name
    with tcfg.gemm_precision(text), stheno_tpu.config.gemm_precision(text):
        assert tbc._active_prec().name == jbc._active_prec().name == text.upper()
    assert tcfg._norm_precision(tcfg.Precision.HIGH) is tcfg.Precision.HIGH


def test_none_and_bad_names_raise_as_the_reference():
    for mod in (stheno_tpu.config, tcfg):
        with pytest.raises(ValueError, match="None"):
            mod.gemm_precision(None)
        with pytest.raises(KeyError):
            mod.gemm_precision("bf16_3x")
        with pytest.raises(KeyError):
            mod.bwd_precision("tf32")
    for mod in (jbc, tbc):
        with pytest.raises(ValueError, match="set_bwd_precision"):
            mod.set_gemm_precision(None)
    # None in bwd_precision means "follow the forward"
    with tcfg.bwd_precision(None), stheno_tpu.config.bwd_precision(None):
        assert tbc._active_bwd_prec() is None and jbc._active_bwd_prec() is None


def test_scopes_nest_and_cannot_leak():
    assert tbc._active_prec() is tcfg.Precision.HIGHEST  # the port's default
    with tcfg.gemm_precision("high"):
        assert tbc._active_prec() is tcfg.Precision.HIGH
        with tcfg.gemm_precision("default"), tcfg.bwd_precision("highest"):
            assert tbc._active_prec() is tcfg.Precision.DEFAULT
            assert tbc._active_bwd_prec() is tcfg.Precision.HIGHEST
        assert tbc._active_prec() is tcfg.Precision.HIGH and tbc._active_bwd_prec() is None
    with pytest.raises(RuntimeError, match="inside"):
        with tcfg.gemm_precision("default"):
            raise RuntimeError("inside")
    assert tbc._active_prec() is tcfg.Precision.HIGHEST


def test_scopes_are_thread_local():
    seen = []
    inside, done = threading.Event(), threading.Event()

    def other():
        with tcfg.gemm_precision("default"):
            inside.set()
            done.wait(10)
            seen.append(tbc._active_prec())

    t = threading.Thread(target=other)
    t.start()
    inside.wait(10)
    here = tbc._active_prec()
    done.set()
    t.join(10)
    assert here is tcfg.Precision.HIGHEST and seen == [tcfg.Precision.DEFAULT]


def test_setters_return_the_previous_value_as_the_reference():
    for mod, cfg in ((jbc, stheno_tpu.config), (tbc, tcfg)):
        first = mod.set_gemm_precision("default")
        try:
            assert mod.set_gemm_precision("high").name == "DEFAULT"
            assert mod._active_prec().name == "HIGH"
            with cfg.gemm_precision("highest"):  # a scope wins over the default
                assert mod._active_prec().name == "HIGHEST"
        finally:
            mod.set_gemm_precision(first)
        assert mod.set_bwd_precision("default") is None
        assert mod.set_bwd_precision(None).name == "DEFAULT"
        prev = mod.set_bwd_params(block=512)
        assert mod.set_bwd_params(*prev) == (prev[0], prev[1], prev[2], 512)
        fn = lambda A: A  # noqa: E731
        prev = mod.set_base_cholesky(fn)
        assert mod.set_base_cholesky(prev) is fn
        prev = mod.set_base_tri_inv(fn)
        assert mod.set_base_tri_inv(prev) is fn
    assert tbc._PREC is tcfg.Precision.HIGHEST and jbc._PREC == lax.Precision.HIGH


def test_snapshot_has_the_reference_keys_and_hashes():
    ref = stheno_tpu.config.snapshot()
    snap = tcfg.snapshot()
    assert [k for k, _ in snap] == [k for k, _ in ref]
    hash(snap)
    with tcfg.gemm_precision("high"), tcfg.bwd_precision("default"), tcfg.bwd_params(block=512):
        inner = dict(tcfg.snapshot())
    assert inner["gemm_precision"] is tcfg.Precision.HIGH
    assert inner["bwd_precision"] is tcfg.Precision.DEFAULT
    assert inner["bwd_params"][3] == 512 and tcfg.snapshot() == snap


def test_default_float_is_torch_default_dtype():
    assert tcfg.default_float() == torch.get_default_dtype() == torch.float32
    before = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        assert tcfg.default_float() == torch.float64
    finally:
        torch.set_default_dtype(before)


# ---- the plain split ------------------------------------------------------------


def _random_f32(n, seed):
    """Values of every exponent (random bits, non-finite ones included)."""
    bits = np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return torch.as_tensor(bits.view(np.int32)).view(torch.float32)


def test_plain_split_properties():
    x = _random_f32(1 << 16, 0)
    x = torch.cat([x, torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, 3.0, -7.5])])
    hi, lo = ts.tf32_split_plain(x)
    finite = torch.isfinite(x)
    hb = hi.view(torch.int32)
    assert bool(((hb & 0x1FFF) == 0)[finite].all())  # TF32: the low 13 bits are zero
    # the rounding carries past the largest float only at |x| ≥ (2 − 2⁻¹¹)·2¹²⁷
    stays = finite & ((x.view(torch.int32) & 0x7FFFFFFF) < 0x7F7FF000)
    assert bool((hi + lo == x)[stays].all())  # exact
    normal = stays & (x.abs() >= 2.0**-126)
    assert bool((lo.abs() <= 2.0**-11 * x.abs())[normal].all())
    # a subnormal's lo is at most half of TF32's last place there, 2⁻¹³⁷
    assert bool((lo.abs() <= 2.0**-137)[stays & ~normal].all())
    assert bool(torch.isinf(hi[finite & ~stays]).all())
    # non-finite values pass through to hi, lo is +0
    nf = ~finite
    assert torch.equal(hi.view(torch.int32)[nf], x.view(torch.int32)[nf])
    assert torch.equal(lo.view(torch.int32)[nf], torch.zeros_like(lo.view(torch.int32)[nf]))


def test_plain_split_ties_go_away_from_zero():
    one = 1.0
    tie = one + 2.0**-11  # halfway between 1 and 1 + 2⁻¹⁰
    x = torch.tensor([tie, -tie, 3 + 2.0**-10, -(3 + 2.0**-10), one + 2.0**-11 - 2.0**-23,
                      one + 3 * 2.0**-11], dtype=torch.float32)
    hi, lo = ts.tf32_split_plain(x)
    assert hi.tolist() == [one + 2.0**-10, -(one + 2.0**-10), 3 + 2.0**-9, -(3 + 2.0**-9), one,
                           one + 2 * 2.0**-10]
    assert torch.equal(hi + lo, x)


def test_split_wrapper_on_the_cpu_is_the_plain_version_and_counts_nothing():
    from stheno_tpu_torch import cuda as kern

    kern.reset_counters()
    x = torch.randn(64, 48)
    for v in (x, x.T, x[:, 3:40], x[None]):
        hi, lo = ts.tf32_split(v)
        ph, pl = ts.tf32_split_plain(v)
        assert torch.equal(hi, ph) and torch.equal(lo, pl) and hi.shape == v.shape
    assert kern.COUNTERS["tf32_split"].total == 0
    with pytest.raises(TypeError):
        ts.tf32_split(x.double())


# ---- the products -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(384, 256, 128), (128, 4096, 64), (2048, 64, 96)],
                         ids=["square", "long_inner", "tall"])
def test_products_against_f64(shape):
    m, k, n = shape
    rng = np.random.default_rng(sum(shape))
    A = torch.as_tensor(rng.normal(size=(m, k)), dtype=torch.float32)
    B = torch.as_tensor(rng.normal(size=(k, n)), dtype=torch.float32)
    ref = A.double() @ B.double()
    scale = (A.double().abs() @ B.double().abs()).max().item()
    err = {}
    for p in PRECISIONS:
        with tcfg.gemm_precision(p):
            err[p] = (tbc._mm(A, B).double() - ref).abs().max().item() / scale
    assert err["high"] <= HIGH_OVER_FP32 * err["highest"], err
    assert err["default"] <= DEFAULT_TOL, err
    # the TF32 rounding is really there: one pass is far from fp32
    assert err["default"] > 10 * err["highest"], err


def test_highest_is_the_plain_product_and_f64_ignores_every_setting(monkeypatch):
    def no_low_precision(*args):
        raise AssertionError("a product below 'highest' ran")

    rng = np.random.default_rng(3)
    A, B = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32) for s in ((96, 64), (64, 80)))
    with monkeypatch.context() as m:
        m.setattr(tbc._LowPrecisionMatmul, "apply", no_low_precision)
        with tcfg.gemm_precision("highest"):
            assert torch.equal(tbc._mm(A, B), A @ B)
            assert torch.equal(tbc._mm(A, B[:, 0]), A @ B[:, 0])
        for p in PRECISIONS:
            with tcfg.gemm_precision(p):
                assert torch.equal(tbc._mm(A.double(), B.double()), A.double() @ B.double())
    # the blocked factor and its gradient: f64 under every pair, bit for bit
    K = torch.as_tensor(_psd(4, 512))
    ct = torch.as_tensor(np.random.default_rng(5).normal(size=(512, 512)))

    def factor_and_grad():
        A_ = K.clone().requires_grad_(True)
        with stt.config.bwd_params(block=256):
            L = tbc.blocked_cholesky(A_, 256, 64)
        (g,) = torch.autograd.grad(L, A_, ct)
        return L.detach(), g

    L0, g0 = factor_and_grad()
    for p in PRECISIONS:
        for bp in (None, *PRECISIONS):
            with tcfg.gemm_precision(p), tcfg.bwd_precision(bp):
                L, g = factor_and_grad()
            assert torch.equal(L, L0) and torch.equal(g, g0), (p, bp)


def test_highest_scope_is_the_default_route_bit_for_bit(monkeypatch):
    """f32 at 'highest' scoped is the route with no scope at all, and no
    low-precision product runs: the flagship step on the blocked route."""
    monkeypatch.setattr(tbc._LowPrecisionMatmul, "apply", lambda *a: pytest.fail("low precision ran"))
    with stt.config.chol_backend("blocked"), stt.config.bwd_params(block=256):
        step, theta = entry.flagship(512, torch.float32, device="cpu")
        v0, g0 = step(theta)
        with tcfg.gemm_precision("highest"), tcfg.bwd_precision("highest"):
            v1, g1 = step(theta)
    assert torch.equal(v0, v1) and all(torch.equal(g0[k], g1[k]) for k in g0)


def test_low_precision_product_gradient_and_second_derivative():
    """Below 'highest' `_mm` is a Function whose backward is the two
    products at the same precision, through itself again."""
    rng = np.random.default_rng(6)
    A0, B0 = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32) for s in ((40, 24), (24, 16)))
    W = torch.as_tensor(rng.normal(size=(40, 16)), dtype=torch.float32)
    for p in ("high", "default"):
        A, B = A0.clone().requires_grad_(True), B0.clone().requires_grad_(True)
        with tcfg.gemm_precision(p):
            C = tbc._mm(A, B)
        assert C.grad_fn is not None and "LowPrecision" in type(C.grad_fn).__name__
        gA, gB = torch.autograd.grad((C * W).sum(), (A, B), create_graph=True)
        with tcfg.gemm_precision(p):
            torch.testing.assert_close(gA, tbc._mm(W, B0.T), rtol=0, atol=0)
            torch.testing.assert_close(gB, tbc._mm(A0.T, W), rtol=0, atol=0)
        # second derivative: d/dB of Σ(gA·V) = Aᵀ-free: Wᵀ V
        V = torch.as_tensor(rng.normal(size=gA.shape), dtype=torch.float32)
        (gBB,) = torch.autograd.grad((gA * V).sum(), B)
        tol = 1e-5 if p == "high" else 1e-2
        torch.testing.assert_close(gBB, (V.T.double() @ W.double()).float(), rtol=tol, atol=tol * 10)


# ---- the blocked factor and its reverse rule ---------------------------------------


@pytest.mark.parametrize("bwd", [None, *PRECISIONS], ids=lambda b: f"bwd={b}")
@pytest.mark.parametrize("gemm", PRECISIONS)
def test_blocked_factor_and_gradient_under_every_pair(gemm, bwd):
    """N = 1024, panels of 256 over bases of 64, backward panels of 512
    (`chol_backend('blocked')`, `bwd_params(block=512)`), f32 on kernels 2
    and 3's plain versions, against the JAX package's f32 factor and
    gradient.  'highest' and 'high' within 1e-5 of its factor (relative to
    max|L|) and of its gradient (of max|g|; 'high' reads 1.6e-7 and 1.3e-6,
    'highest' 1.6e-7 and 5.0e-7).  A 'default' factor or backward (one TF32
    pass, about 2⁻¹¹ an operand) is a reading, held to 1e-3 (factor, reads
    4.0e-5) and 5e-3 (gradient, reads 6.9e-4)."""
    n = 1024
    K = _psd(10, n, np.float32)
    ct = np.random.default_rng(11).normal(size=(n, n)).astype(np.float32)
    with stheno_tpu.config.bwd_params(block=512), stheno_tpu.config.gemm_precision("highest"):
        L_ref, vjp = jax.vjp(lambda A: jbc.blocked_cholesky(A, 256, 64), jnp.asarray(K))
        g_ref = np.asarray(vjp(jnp.asarray(ct))[0])
    L_ref = np.asarray(L_ref)
    A = torch.tensor(K, requires_grad=True)
    with stt.config.chol_backend("blocked"), stt.config.bwd_params(block=512), \
            tcfg.gemm_precision(gemm), tcfg.bwd_precision(bwd):
        L = tchol.cholesky_psd(A)
    (g,) = torch.autograd.grad(L, A, torch.as_tensor(ct))
    L, g = L.detach().numpy(), g.numpy()
    assert np.isfinite(L).all() and np.isfinite(g).all()
    fwd_tol = 1e-5 if gemm != "default" else 1e-3
    np.testing.assert_allclose(L, L_ref, rtol=0, atol=fwd_tol * np.abs(L_ref).max())
    eff = bwd if bwd is not None else gemm
    grad_tol = 1e-5 if eff != "default" and gemm != "default" else 5e-3
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=grad_tol * np.abs(g_ref).max())


def test_a_backward_precision_unlike_the_forward_rebuilds_the_inverses(monkeypatch):
    """The forward's panel inverses are made at its precision: the reverse
    rule reuses them only when it runs at the same one (reference
    `blocked_cholesky.py:675-689`), and otherwise rebuilds the inverses it
    needs at its own."""
    calls = []
    real = tbc._base_tri_inv

    def counted(L):
        calls.append((tbc._active_prec(), L.shape[-1]))
        return real(L)

    # every inverse, rebuilt block by block or as a stack, starts at the base case
    monkeypatch.setattr(tbc, "_base_tri_inv", counted)
    K = torch.as_tensor(_psd(12, 512, np.float32))

    def backward_calls(gemm, bwd):
        A = K.clone().requires_grad_(True)
        with tcfg.gemm_precision(gemm), tcfg.bwd_precision(bwd), stt.config.bwd_params(block=256):
            L = tbc.blocked_cholesky(A, 256, 64)
        calls.clear()
        torch.autograd.grad(L.sum(), A)
        return list(calls)

    assert backward_calls("high", None) == []           # reused
    assert backward_calls("high", "high") == []         # same precision: reused
    rebuilt = backward_calls("high", "highest")
    assert rebuilt and {p for p, _ in rebuilt} == {tcfg.Precision.HIGHEST}
    rebuilt = backward_calls("highest", "default")
    assert rebuilt and {p for p, _ in rebuilt} == {tcfg.Precision.DEFAULT}


def test_reverse_rules_run_at_the_forward_precision_after_its_scope_closed(monkeypatch):
    """`loss.backward()` runs after the `with` block: the blocked factor,
    the solves and the fused logpdf take the forward's precision along."""
    seen = []
    real = tbc._products

    def spy(a, b, prec):
        seen.append(prec)
        return real(a, b, prec)

    monkeypatch.setattr(tbc, "_products", spy)
    K = torch.as_tensor(_psd(13, 512, np.float32))
    y = torch.as_tensor(np.random.default_rng(14).normal(size=512), dtype=torch.float32)
    for fn in (lambda A: tbc.blocked_cholesky(A, 256, 64).sum(),
               lambda A: tbc.blocked_solve_lower(torch.linalg.cholesky(A), y, 256).sum(),
               lambda A: tchol._MvnLogpdfFused.apply(A, y)):
        A = K.clone().requires_grad_(True)
        with stt.config.chol_backend("blocked"), tcfg.gemm_precision("default"):
            out = fn(A)
        seen.clear()
        torch.autograd.grad(out, A)
        assert seen and set(seen) == {tcfg.Precision.DEFAULT}


def test_ordinary_autograd_through_low_precision_products():
    """Blocked LAUUM and the blocked triangular inverse are differentiated
    by ordinary autograd: at 'high' their gradients are 'highest''s within
    1e-5 relative (of the largest entry), and the products below 'highest'
    do run."""
    M0 = torch.as_tensor(np.linalg.cholesky(_psd(15, 512)), dtype=torch.float32)
    W = torch.as_tensor(np.random.default_rng(16).normal(size=(512, 512)), dtype=torch.float32)

    def grads(p):
        M = M0.clone().requires_grad_(True)
        # kernel 3's plain version updates in place (it stands in for a
        # launch and is not differentiated): the library base inverse here
        with tcfg.gemm_precision(p), stt.config.scoped(base_tri_inv=tbc.torch_tri_inv_lower):
            out = (tbc.blocked_lauum(tbc.blocked_tri_inv_lower(M, 64), 128) * W).sum()
            (g,) = torch.autograd.grad(out, M)
        return g

    g_hi, g_high = grads("highest"), grads("high")
    rel = ((g_high - g_hi).abs().max() / g_hi.abs().max()).item()
    assert 0 < rel <= 1e-5, rel


def test_distributed_factor_gradient_at_high_on_two_gloo_ranks(tmp_path):
    """The distributed panel loops (slab and cyclic) and the distributed
    solves are differentiated by ordinary autograd through `_mm`: at 'high'
    on two gloo ranks, their values and slab gradients within 1e-5
    relative of 'highest', with products below 'highest' run."""
    n = 128
    rng = np.random.default_rng(17)
    inp = dict(K=_psd(18, n, np.float32), W=rng.normal(size=(n, n)).astype(np.float32),
               Bm=rng.normal(size=(n, 3)).astype(np.float32), B=16)
    outs = spawn("precision", 2, inp, tmp_path)
    for out in outs:
        assert out["low_precision_products"] > 0
        for key in ("slab", "cyclic", "solve"):
            hi, high = out[f"g_{key}_highest"], out[f"g_{key}_high"]
            rel = np.abs(high - hi).max() / np.abs(hi).max()
            assert rel <= 1e-5, (key, rel)
            np.testing.assert_allclose(out[f"f_{key}_high"], out[f"f_{key}_highest"], rtol=1e-5)


def test_vmapped_factor_never_reaches_the_low_precision_products(monkeypatch):
    """Under `torch.func.vmap` the factor takes `torch.linalg`
    (`ops/chol.py:_use_blocked`), so `_mm`'s Function, which has no vmap
    rule, is never reached: a vmapped log-density under 'high' and on the
    blocked backend is 'highest''s bit for bit."""
    monkeypatch.setattr(tbc._LowPrecisionMatmul, "apply", lambda *a: pytest.fail("low precision ran"))
    data = entry.nuts_data(256, torch.float32, "cpu")
    fn, theta0, _ = entry.nuts_logdensity(data)
    thetas = theta0[None, :] + 0.1 * torch.as_tensor(np.random.default_rng(19).normal(size=(3, 3)),
                                                     dtype=torch.float32)
    batched = torch.func.vmap(torch.func.grad_and_value(fn))
    with stt.config.chol_backend("blocked"):
        g0, v0 = batched(thetas)
        with tcfg.gemm_precision("high"):
            g1, v1 = batched(thetas)
    assert torch.equal(g0, g1) and torch.equal(v0, v1)


# ---- record_chol_sizes ---------------------------------------------------------------


def _t_programme(theta, x, y):
    K = torch.exp(theta[0]) * torch.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) + 0.1 * torch.eye(
        x.shape[0], dtype=x.dtype)
    small = K[:7, :7]
    return tchol.mvn_logpdf_psd(y, torch.zeros_like(y), K) + tchol.chol_logdet(
        tchol.cholesky_psd(small))


def _j_programme(theta, x, y):
    K = jnp.exp(theta[0]) * jnp.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) + 0.1 * jnp.eye(
        x.shape[0], dtype=x.dtype)
    small = K[:7, :7]
    return jchol.mvn_logpdf_psd(y, jnp.zeros_like(y), K) + jchol.chol_logdet(
        jchol.cholesky_psd(small))


@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_record_chol_sizes_matches_the_reference(dtype, fused):
    n = 96
    x = np.linspace(-3, 3, n).astype(dtype)
    y = np.sin(x).astype(dtype)
    th = np.zeros(1, dtype=dtype)
    with stheno_tpu.config.scoped(logpdf_fused=fused), jchol.record_chol_sizes() as ref:
        jax.eval_shape(lambda t: _j_programme(t, jnp.asarray(x), jnp.asarray(y)), jnp.asarray(th))
    with stt.config.logpdf_fused(fused), tchol.record_chol_sizes() as got:
        with tchol.record_chol_sizes() as inner:  # nested: the inner block collects its own
            _t_programme(torch.as_tensor(th), torch.as_tensor(x), torch.as_tensor(y))
    assert not got
    assert [(n_, str(d).split(".")[-1]) for n_, d in inner] == [(n_, str(d)) for n_, d in ref]
    assert inner == [(n, getattr(torch, dtype)), (7, getattr(torch, dtype))]
    assert getattr(tchol._rec_tls, "sizes", None) is None


# ---- the samplers' precision policy -----------------------------------------------------


def _policy_pair(n, dtype, precision):
    """The reference's and the port's `_precision_policy` decision on the same
    programme at size n: (resolved name or None, warned) each."""
    x = np.linspace(-3, 3, n).astype(dtype)
    y = np.sin(x).astype(dtype)
    t0 = np.zeros(1, dtype=dtype)
    out = []
    for run in ("ref", "port"):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            if run == "ref":
                f = lambda t: _j_programme(t, jnp.asarray(x), jnp.asarray(y))  # noqa: E731
                ctx, p = jh._precision_policy(precision, f, 1, jnp.dtype(dtype))
            else:
                f = lambda t: _t_programme(t, torch.as_tensor(x), torch.as_tensor(y))  # noqa: E731
                ctx, p = th._precision_policy(precision, f, torch.as_tensor(t0))
        with ctx:
            active = (jbc._active_prec() if run == "ref" else tbc._active_prec()).name
        warned = any("precision='auto'" in str(m.message) for m in w)
        out.append((None if p is None else p.name, warned, active))
    return out


@pytest.mark.parametrize("n,dtype,expect", [
    (4096, "float32", ("HIGHEST", True)),    # a large f32 covariance below 'highest': pinned
    (2048, "float32", (None, False)),        # below AUTO_HIGHEST_MIN_N
    (4096, "float64", (None, False)),        # f64
], ids=["n4096_f32", "n2048_f32", "n4096_f64"])
def test_auto_policy_decides_as_the_reference(n, dtype, expect):
    jax.config.update("jax_enable_x64", True)
    with stheno_tpu.config.gemm_precision("high"), tcfg.gemm_precision("high"):
        (ref_p, ref_w, ref_active), (p, w, active) = _policy_pair(n, dtype, "auto")
    assert (ref_p, ref_w) == (p, w) == expect
    assert ref_active == active == (expect[0] or "HIGH")


def test_auto_policy_at_highest_evaluates_nothing():
    calls = []
    ctx, p = th._precision_policy("auto", lambda q: calls.append(q), torch.zeros(2))
    assert p is None and calls == []


def test_explicit_none_and_bad_precisions_as_the_reference():
    for precision in ("high", "HIGHEST", "default", tcfg.Precision.HIGH):
        ref = jh._precision_policy(precision if isinstance(precision, str) else "high",
                                   lambda q: q, 1, jnp.float32)
        ctx, p = th._precision_policy(precision, lambda q: q, torch.zeros(1))
        assert p.name == ref[1].name
        with ctx:
            assert tbc._active_prec() is p
    assert th._precision_policy(None, lambda q: q, torch.zeros(1))[1] is None
    with pytest.raises(KeyError):
        jh._precision_policy("bf16_3x", lambda q: q, 1, jnp.float32)
    with pytest.raises(KeyError):
        th._precision_policy("bf16_3x", lambda q: q, torch.zeros(1))
    # an evaluation that raises: no policy, as in the reference
    with tcfg.gemm_precision("high"):
        ctx, p = th._precision_policy("auto", lambda q: 1 / 0, torch.zeros(1))
    assert p is None


def test_run_nuts_takes_every_precision_and_hints_below_highest():
    """`run_nuts` and `nuts_warmup` accept the reference's precisions, scope
    them over the run, and the mixing warning of an f32 run below 'highest'
    carries the precision hint."""
    seen = []

    def logp(q):
        seen.append(tbc._active_prec())
        return -0.5 * torch.sum(q**2)

    z = torch.zeros(2, dtype=torch.float32)
    for precision in ("high", "default", "highest", tcfg.Precision.HIGH):
        seen.clear()
        th.nuts_warmup(0, logp, z, num_warmup=2, precision=precision)
        assert seen and set(seen) == {tcfg._norm_precision(precision)}
    # unmixed chains (a tiny fixed step from far apart), f32, under 'high'
    q = torch.tensor([[-3.0, 3.0], [3.0, -3.0]])
    state = th.ChainState(q, -0.5 * (q**2).sum(1), -q, torch.full((2,), 1e-3), torch.ones_like(q))
    with pytest.warns(UserWarning, match="below 'highest'"):
        th.run_nuts(0, logp, z, num_samples=20, num_chains=2, resume_state=state, max_depth=3,
                    precision="high")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        th.run_nuts(0, logp, z, num_samples=20, num_chains=2, resume_state=state, max_depth=3,
                    precision="highest")
    msgs = [str(m.message) for m in w]
    assert any("have not mixed" in m for m in msgs) and not any("below 'highest'" in m for m in msgs)


def test_sharded_nuts_passes_the_precision_through():
    """`parallel.run_nuts_sharded` hands `precision` to `run_nuts` (a
    one-rank gloo group in this process)."""
    import torch.distributed as dist

    from stheno_tpu_torch.parallel import chains_mesh, run_nuts_sharded

    seen = []

    def logp(q):
        seen.append(tbc._active_prec())
        return -0.5 * torch.sum(q**2)

    mesh = chains_mesh(device_type="cpu")
    try:
        run_nuts_sharded(0, logp, torch.zeros(2), mesh, num_warmup=2, num_samples=2,
                         num_chains=2, precision="default", check_rhat=False)
    finally:
        dist.destroy_process_group()
    assert seen and set(seen) == {tcfg.Precision.DEFAULT}

"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch and the CUDA toolkit, without the suite's conftest:

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import stheno_tpu_torch as stt
from stheno_tpu_torch import cuda as kern
from stheno_tpu_torch import entry
from stheno_tpu_torch.ops import chol as tchol
from stheno_tpu_torch.cuda import chol_block as tcb
from stheno_tpu_torch.cuda import kernelmatrix as tkm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _spd_stack(batch, n, seed, dtype, device):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(batch, n, n))
    A = G @ np.swapaxes(G, 1, 2) / n + np.eye(n)
    return torch.as_tensor(A, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", sorted(tkm.KINDS))
def test_kernelmatrix_matches_plain(cuda_device, kind, dtype):
    rng = np.random.default_rng(8)
    # D = 1..16 are compiled instances, 17 the generic one; M = 777 ends
    # its rows off a 16-byte boundary (scalar stores), N = 1000 on one
    for dim in (1, 2, 3, 4, 9, 16, 17):
        ell = np.linspace(0.7, 2.1, dim) * np.sqrt(dim)
        xs = torch.as_tensor(rng.normal(size=(1000, dim)) / ell, dtype=dtype, device=cuda_device)
        ys = torch.as_tensor(rng.normal(size=(777, dim)) / ell, dtype=dtype, device=cuda_device)
        v = torch.tensor(1.7, dtype=dtype, device=cuda_device)
        for yy in (None, ys):
            K = tkm.kernelmatrix_forward(xs, yy, kind, v)
            # fp32 exp and FMA rounding on values in [0, 1.7]
            atol = 1e-5 if dtype == torch.float32 else 1e-13
            torch.testing.assert_close(K, tkm.kernelmatrix_plain(xs, yy, kind, v), rtol=0, atol=atol)
            if yy is None:
                assert bool((K.diagonal() == v).all())


@pytest.mark.parametrize("batch,n", [
    (1, 256),     # the main path's shapes
    (4, 256),
    (3, 200),     # ragged
    (132, 256),   # one block per SM
    (2, 1),       # one padded tile
    (2, 33),      # a tile and one row
    (1, 255),
    (1, 288),     # kernel 2's limit
])
def test_chol_and_tri_inv_match_plain(cuda_device, batch, n):
    A = _spd_stack(batch, n, 9, torch.float32, cuda_device)
    # only tril(A) is read: garbage in the strict upper triangle is ignored
    A = A + torch.triu(torch.full_like(A, 1e3), 1)
    L = tcb.chol_block(A)
    Lp = tcb.chol_block_plain(A)
    torch.testing.assert_close(L, Lp, rtol=0, atol=1e-4 * Lp.abs().max().item())
    M = tcb.tri_inv_block(Lp)
    Mp = tcb.tri_inv_block_plain(Lp)
    torch.testing.assert_close(M, Mp, rtol=0, atol=1e-4 * Mp.abs().max().item())
    # kernel 3 reads tril(L) only, too
    G = Lp + torch.triu(torch.full_like(Lp, 1e3), 1)
    torch.testing.assert_close(tcb.tri_inv_block(G), Mp, rtol=0, atol=1e-4 * Mp.abs().max().item())
    # each kernel's arithmetic is in a fixed order, so a repeat that differs
    # in any bit means threads raced
    for _ in range(10):
        assert torch.equal(tcb.chol_block(A), L)
        assert torch.equal(tcb.tri_inv_block(Lp), M)


@pytest.mark.parametrize("name", ["chol_block", "tri_inv_block"])
def test_smem_layout_matches_library(cuda_device, name):
    # `fits` decides on the CPU from a copy of the kernels' shared-memory sizes
    for n in (1, 31, 32, 33, 200, 255, 256, 288, 289, 320, 337, 338):
        assert tcb._smem_bytes(name, n) == tcb.library_smem_bytes(name, n), n


def test_km_se_d1_matches_plain(cuda_device):
    x = torch.linspace(-5.0, 5.0, 4099, device=cuda_device)
    K = tkm.km_se_d1(x)
    torch.testing.assert_close(K, tkm.km_se_d1_plain(x), rtol=0, atol=1e-5)
    assert bool((K.diagonal() == 1.5).all())


def test_each_launch_counts_once_and_bad_input_raises(cuda_device):
    kern.reset_counters()
    A = _spd_stack(1, 64, 10, torch.float32, cuda_device)[0]
    L = tcb.chol_block(A)
    tcb.tri_inv_block(L)
    x = torch.linspace(-1, 1, 50, device=cuda_device)[:, None]
    tkm.kernelmatrix_forward(x, None, "se", torch.tensor(1.0, device=cuda_device))
    tkm.km_se_d1(x[:, 0])
    torch.cuda.synchronize()
    assert {k: c.total for k, c in kern.COUNTERS.items()} == {
        "kernelmatrix": 1, "kernelmatrix_batched": 0, "kernelmatrix_vjp": 0, "chol_block": 1,
        "tri_inv_block": 1, "km_se_d1": 1, "tf32_split": 0}
    with pytest.raises(TypeError):
        tcb.chol_block(A.half())
    with pytest.raises(TypeError):  # the kernels are f32 only
        tcb.tri_inv_block(L.double())
    with pytest.raises(ValueError):  # the working set exceeds shared memory
        tcb.chol_block(_spd_stack(1, 400, 11, torch.float32, cuda_device))
    with pytest.raises(ValueError):
        tcb.chol_block(_spd_stack(1, 289, 11, torch.float32, cuda_device))
    with pytest.raises(ValueError):
        tcb.tri_inv_block(L[None, :, :10])
    with pytest.raises(ValueError):  # the first n past kernel 3's limit, 288
        tcb.tri_inv_block(torch.eye(289, device=cuda_device))
    one = torch.tensor(1.0, device=cuda_device)
    strided = torch.zeros(50, 2, device=cuda_device)[:, :1]  # not contiguous
    with pytest.raises(ValueError):
        tkm.kernelmatrix_forward(strided, None, "se", one)
    with pytest.raises(ValueError):  # D differs
        tkm.kernelmatrix_forward(x, torch.zeros(7, 2, device=cuda_device), "se", one)
    with pytest.raises(ValueError):
        tkm.kernelmatrix_forward(x, None, "rq", torch.tensor(1.0, device=cuda_device))
    assert kern.COUNTERS["chol_block"].total == 1


def _se_nlml(x, y, v, noise):
    with stt.GPC():
        f = stt.GP(v * stt.with_lengthscale(stt.SEKernel(), 0.7))
    return -stt.logpdf(f(x, noise), y)


def test_f64_logpdf_at_4096_takes_the_library_bases(cuda_device):
    """An f64 covariance at N = 4096 on the card goes to the blocked factor,
    whose base cases are chosen by dtype: the library's for f64 (kernels 2
    and 3 take f32 only, and raise on f64 when called directly).  Value and
    gradient against the torch.linalg route."""
    f64 = torch.float64
    x = torch.linspace(-5.0, 5.0, 4096, dtype=f64, device=cuda_device)
    y = torch.sin(x) + 0.2 * torch.cos(7 * x)
    K = torch.eye(4096, dtype=f64, device=cuda_device)
    assert tchol._use_blocked(K)

    def value_and_grad():
        v = torch.tensor(1.5, dtype=f64, device=cuda_device, requires_grad=True)
        noise = torch.tensor(0.1, dtype=f64, device=cuda_device, requires_grad=True)
        val = _se_nlml(x, y, v, noise)
        return val.item(), [g.item() for g in torch.autograd.grad(val, (v, noise))]

    kern.reset_counters()
    val, grad = value_and_grad()
    torch.cuda.synchronize()
    assert kern.COUNTERS["chol_block"].total == 0 and kern.COUNTERS["tri_inv_block"].total == 0
    assert kern.COUNTERS["kernelmatrix"].total == 1  # kernel 1 takes f64
    with stt.config.chol_backend("torch"):
        val_ref, grad_ref = value_and_grad()
    np.testing.assert_allclose(val, val_ref, rtol=1e-9)
    np.testing.assert_allclose(grad, grad_ref, rtol=1e-7)
    A = _spd_stack(1, 64, 12, f64, cuda_device)
    with pytest.raises(TypeError):
        tcb.chol_block(A)
    with pytest.raises(TypeError):
        tcb.tri_inv_block(torch.linalg.cholesky(A))


def test_host_y_and_full_noise_move_to_the_card(cuda_device):
    """A numpy y and a numpy (N, N) noise with inputs on the card: both are
    moved to the covariance's device and dtype."""
    rng = np.random.default_rng(13)
    xh = np.sort(rng.uniform(-3, 3, 300))
    y = np.sin(xh) + 0.1 * rng.normal(size=300)
    S = np.diag(0.05 + 0.1 * rng.uniform(size=300)) + 0.01
    out = {}
    for dev in ("cpu", cuda_device):
        x = torch.as_tensor(xh, dtype=torch.float32, device=dev)
        with stt.GPC():
            f = stt.GP(stt.SEKernel())
        fx = f(x, S)
        post = stt.posterior(fx, y)
        out[str(dev)] = (stt.logpdf(fx, y).item(), post.mean(x[:50]).cpu().numpy())
    (lp_cpu, m_cpu), (lp_gpu, m_gpu) = out.values()
    np.testing.assert_allclose(lp_gpu, lp_cpu, rtol=1e-4)
    np.testing.assert_allclose(m_gpu, m_cpu, rtol=0, atol=1e-4)


def test_pseudo_point_step_at_4096_launches_the_kernels(cuda_device):
    """The −ELBO of the pseudo-point programme at N = 4096 with 2048
    inducing inputs per latent (a 4096² Kuu and B, so the blocked route):
    four kernel-1 launches (Kuu's two same-input blocks and Kuf's two cross
    blocks), kernels 2 and 3 launched, and value and gradient against f64 on
    the card (1e-3 relative; 5e-3 of the gradient's largest component)."""
    from stheno_tpu_torch import entry
    from stheno_tpu_torch import params as P

    data = entry.pseudo_points_data(4096, 2048, torch.float32, cuda_device, half_width=1024.0)
    theta0, _ = P.init(entry.pseudo_points_spec(data[2]))
    kern.reset_counters()
    val, grad = entry.pseudo_points_step(theta0, data)
    torch.cuda.synchronize()
    counts = {k: c.total for k, c in kern.COUNTERS.items()}
    assert counts["kernelmatrix"] == 4, counts
    assert counts["chol_block"] > 0 and counts["tri_inv_block"] > 0, counts
    val64, grad64 = entry.pseudo_points_step(theta0.double(), tuple(t.double() for t in data))
    np.testing.assert_allclose(val.item(), val64.item(), rtol=1e-3)
    err = ((grad.double() - grad64).abs().max() / grad64.abs().max()).item()
    assert err <= 5e-3, err


def test_fused_vfe_products_at_4096_are_as_accurate_as_the_composite_chain(cuda_device):
    """The pseudo-point bound's substitution and products (A Aᵀ, A b, Σ A²
    of A = L⁻¹ K̃) at M = 4096, N = 32768, f32 on the blocked route: each
    input's gradient through `_VfeProducts` lies no further from a float64
    CPU run of the composite chain, on the same f32 inputs, than the f32
    composite chain's does, by a factor of 2 at most (relative Frobenius
    norms)."""
    m, n = 4096, 32768
    g = torch.Generator().manual_seed(5)
    half = 0.75 * m
    z = torch.linspace(-half, half, m, dtype=torch.float64)
    x, _ = torch.sort(torch.rand(n, generator=g, dtype=torch.float64) * (2 * half) - half)

    def se(a, c):
        return torch.exp(-0.5 * (a[:, None] - c[None, :]) ** 2)

    s = 0.05 + 0.3 * torch.rand(n, generator=g, dtype=torch.float64)
    y = torch.sin(x / 2) + s.sqrt() * torch.randn(n, generator=g, dtype=torch.float64)
    inputs = [t.float().double() for t in (
        torch.linalg.cholesky(se(z, z) + 1e-6 * torch.eye(m, dtype=torch.float64)),
        se(z, x) / s.sqrt()[None, :], (y - 0.7 - 0.1 * x) / s.sqrt())]
    W, v = torch.randn(m, m, generator=g, dtype=torch.float64), torch.randn(m, generator=g,
                                                                            dtype=torch.float64)

    def grads(products, device, dtype):
        leaves = [t.to(device, dtype).requires_grad_(True) for t in inputs]
        Bp, a, t = products(*leaves)
        val = torch.sum(W.to(device, dtype) * Bp) + a @ v.to(device, dtype) - 0.3 * t
        return [gr.double().cpu() for gr in torch.autograd.grad(val, leaves)]

    want = grads(tchol._vfe_products_composite, "cpu", torch.float64)
    with stt.config.chol_backend("blocked"):
        fused = grads(tchol._VfeProducts.apply, cuda_device, torch.float32)
        composite = grads(tchol._vfe_products_composite, cuda_device, torch.float32)
    for name, f, c, w in zip(("L", "K", "b"), fused, composite, want):
        err_f = (torch.linalg.norm(f - w) / torch.linalg.norm(w)).item()
        err_c = (torch.linalg.norm(c - w) / torch.linalg.norm(w)).item()
        print(f"{name}: fused {err_f:.3e}, composite {err_c:.3e}")
        assert err_f <= 2.0 * err_c, (name, err_f, err_c)


def test_symmetric_product_at_4096_is_the_full_product_mirrored(cuda_device, monkeypatch):
    """B' = A Aᵀ at M = 4096, N = 32768, f32, from its lower blocks
    (`_sym_product`: two levels and the leaves, three batched products):
    exactly symmetric, and within float32 rounding of `A @ A.T`: its largest
    gap to it, and to a float64 product, relative to max |B'|, at most
    twice `A @ A.T`'s own gap to the float64 product."""
    m, n = 4096, 32768
    g = torch.Generator(device=cuda_device).manual_seed(6)
    A = torch.randn(m, n, generator=g, device=cuda_device)
    shapes = []
    bmm = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda *a, **k: shapes.append(tuple(a[0].shape)) or bmm(*a, **k))
    got = tchol._sym_product(A)
    assert shapes == [(1, 2048, n), (2, 1024, n), (4, 1024, n)]
    lib = A @ A.T
    A64 = A.double()
    want = A64 @ A64.T
    scale = got.abs().max().item()
    assert torch.equal(got, got.T)
    gap = (got - lib).abs().max().item() / scale
    err_sym = (got.double() - want).abs().max().item() / scale
    err_lib = (lib.double() - want).abs().max().item() / scale
    print(f"gap {gap:.3e}, sym {err_sym:.3e}, lib {err_lib:.3e}")
    assert gap <= 2.0 * err_lib, (gap, err_lib)
    assert err_sym <= 2.0 * err_lib, (err_sym, err_lib)


def test_wide_blocked_solves_at_4096_are_as_accurate_as_the_library(cuda_device):
    """f32 at M = 4096 against an 8192-column right-hand side: the blocked
    forward and transposed substitutions, whose diagonal blocks are GEMMs
    against one stack of their inverses (one kernel-3 launch a solve),
    measured against float64 beside `torch.linalg.solve_triangular` on the
    same f32 inputs (relative Frobenius norms).  On the suite's G Gᵀ/M + I
    they lie within 4× of the library's error; on an SE Gram matrix of
    sorted points 16 to a length scale plus jitter 1e-3 to 1e-6·I, whose
    diagonal blocks' κ grows as the jitter falls, within the library's
    own.  One kernel-3 launch serves a `vfe_products` forward and its
    backward."""
    m, k = 4096, 8192
    g = torch.Generator().manual_seed(21)
    x = torch.sort(torch.rand(m, generator=g, dtype=torch.float64) * (m / 16)).values
    se = torch.exp(-0.5 * (x[:, None] - x[None, :]) ** 2)
    grams = {"ggt": _spd_stack(1, m, 21, torch.float64, "cpu")[0]}
    grams.update({f"se{j:.0e}": se + j * torch.eye(m, dtype=torch.float64) for j in (1e-3, 1e-4, 1e-5, 1e-6)})
    b = torch.randn(m, k, generator=g, dtype=torch.float64).float().to(cuda_device)
    for name, K in grams.items():
        L = torch.linalg.cholesky(K.to(cuda_device)).float()
        for trans in (False, True):
            want = torch.linalg.solve_triangular(L.double().mT if trans else L.double(), b.double(),
                                                 upper=trans)
            library = torch.linalg.solve_triangular(L.mT if trans else L, b, upper=trans)
            kern.reset_counters()
            with stt.config.chol_backend("blocked"):
                got = tchol.solve_lower(L, b, trans=trans)
            torch.cuda.synchronize()
            assert kern.COUNTERS["tri_inv_block"].total == 1
            err, err_lib = ((torch.linalg.norm(v.double() - want) / torch.linalg.norm(want)).item()
                            for v in (got, library))
            print(f"{name} trans={trans}: blocked {err:.3e}, library {err_lib:.3e}")
            assert err <= (4.0 if name == "ggt" else 1.0) * err_lib, (name, trans, err, err_lib)
    leaves = [t.detach().requires_grad_(True) for t in (
        L, torch.randn(m, k, generator=g).to(cuda_device), torch.randn(k, generator=g).to(cuda_device))]
    kern.reset_counters()
    with stt.config.chol_backend("blocked"):
        Bp, a, t = tchol.vfe_products(*leaves)
        torch.autograd.grad(Bp.sum() + a.sum() + t, leaves)
    torch.cuda.synchronize()
    assert kern.COUNTERS["tri_inv_block"].total == 1


def test_fused_logpdf_at_4096_matches_the_default_route(cuda_device):
    """An f32 logpdf at N = 4096 under `logpdf_fused("on")` against the
    default route: value (1e-4 relative) and gradient (5e-3), with kernel 3
    launched by the fused backward."""
    x = torch.linspace(-5.0, 5.0, 4096, device=cuda_device)
    y = torch.sin(x) + 0.2 * torch.cos(7 * x)

    def value_and_grad():
        v = torch.tensor(1.5, device=cuda_device, requires_grad=True)
        noise = torch.tensor(0.1, device=cuda_device, requires_grad=True)
        val = _se_nlml(x, y, v, noise)
        kern.reset_counters()
        grads = torch.autograd.grad(val, (v, noise))
        torch.cuda.synchronize()
        return val.item(), [g.item() for g in grads], kern.COUNTERS["tri_inv_block"].total

    base_val, base_grad, _ = value_and_grad()
    with stt.config.logpdf_fused("on"):
        val, grad, tri_inv_in_backward = value_and_grad()
    assert tri_inv_in_backward > 0
    np.testing.assert_allclose(val, base_val, rtol=1e-4)
    np.testing.assert_allclose(grad, base_grad, rtol=5e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_batched_kernelmatrix_matches_plain(cuda_device, dtype):
    """The batched launch (a grid dimension over the batch) against its
    batched plain version, at ragged N and M, D = 1 and 3, same-input and
    cross, an operand shared by the batch (an expanded view, batch stride
    0) included; and C = 1 against the unbatched launch, bit for bit."""
    gen = torch.Generator(device="cpu").manual_seed(11)
    atol = 1e-5 if dtype == torch.float32 else 1e-13
    for dim in (1, 3):
        x = (torch.randn(5, 1000, dim, generator=gen) * 2).to(cuda_device, dtype)
        y = (torch.randn(5, 777, dim, generator=gen) * 2).to(cuda_device, dtype)
        shared = y[0].expand(5, 777, dim)
        var = (torch.rand(5, generator=gen) + 0.5).to(cuda_device, dtype)
        for kind in sorted(tkm.KINDS):
            for yy in (None, y, shared):
                kern.reset_counters()
                K = tkm.kernelmatrix_batched_forward(x, yy, kind, var)
                assert kern.COUNTERS["kernelmatrix_batched"].total == 1
                Kp = tkm.kernelmatrix_plain(x, None if yy is None else yy.contiguous(), kind, var)
                torch.testing.assert_close(K, Kp, rtol=0, atol=atol)
                if yy is None:
                    assert bool((K.diagonal(dim1=-2, dim2=-1) == var[:, None]).all())
        one = tkm.kernelmatrix_batched_forward(x[:1], y[:1], "matern32", var[:1])
        assert torch.equal(one[0], tkm.kernelmatrix_forward(x[0], y[0], "matern32", var[0]))


def test_vmapped_logdensity_at_4096_takes_torch_linalg(cuda_device):
    """`torch.func.vmap(grad_and_value)` of the NUTS model's log-density at
    N = 4096 in f32 over 4 chains: one batched launch of kernel 1 for the
    forward, no unbatched one, and neither kernel 2 nor kernel 3 (the
    batch is factored by `torch.linalg`); per chain it agrees with the
    unbatched log-density, whose factor takes the blocked path."""
    data = entry.nuts_data(4096, torch.float32, cuda_device)
    fn, theta0, _ = entry.nuts_logdensity(data)
    thetas = theta0[None, :] + 0.1 * torch.randn(4, 3, generator=torch.Generator(device="cpu").manual_seed(0)).to(cuda_device)
    kern.reset_counters()
    grad, val = torch.func.vmap(torch.func.grad_and_value(fn))(thetas)
    torch.cuda.synchronize()
    counts = {k: c.total for k, c in kern.COUNTERS.items()}
    assert counts == {"kernelmatrix": 0, "kernelmatrix_batched": 1, "kernelmatrix_vjp": 1,
                      "chol_block": 0, "tri_inv_block": 0, "km_se_d1": 0, "tf32_split": 0}, counts
    assert list(kern.COUNTERS["kernelmatrix_batched"].by_shape) == [(4, 4096, 4096, 1, True)]
    for c in range(4):
        th = thetas[c].clone().requires_grad_(True)
        v = fn(th)
        (g,) = torch.autograd.grad(v, th)
        # f32 at N = 4096: the batched torch.linalg factor against the blocked one
        np.testing.assert_allclose(val[c].item(), v.item(), rtol=1e-4)
        assert ((grad[c] - g).abs().max() / g.abs().max()).item() <= 5e-3


def test_resume_is_bit_identical_on_the_card(cuda_device):
    """NUTS over 4 chains of the GP model (N = 256, f32) on the card: a run
    cut into two resumed halves gives the same draws as one run, bit for bit."""
    data = entry.nuts_data(256, torch.float32, cuda_device)
    whole = entry.nuts_run(20, 12, 4, max_depth=6, data=data, seed=2, check_rhat=False)
    first = entry.nuts_run(20, 6, 4, max_depth=6, data=data, seed=2, check_rhat=False)
    second = entry.nuts_run(num_samples=6, num_chains=4, max_depth=6, data=data, seed=2,
                            resume_state=first.state, sample_offset=6, check_rhat=False)
    assert torch.equal(whole.theta, torch.cat([first.theta, second.theta], dim=1))
    assert torch.equal(whole.state.q, second.state.q)


def _jvp_ones(fn, x):
    return torch.func.jvp(fn, (x,), (torch.ones_like(x),))[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("kind", ["se", "matern32"])
def test_kernelmatrix_jvp_matches_plain_on_the_card(cuda_device, kind, dim, dtype):
    """Kernel 1's forward-mode rule on the card (the kernel's primal, the
    rule's tangent) against `torch.func.jvp` over the plain version in f64:
    the first tangent in y, the nested one (∂ₓ∂_y K) and reverse mode over
    it (a sum over the 350000 entries, so relative), with the kernel
    launched once per call of the Function.  A Matern kernel's nested
    tangent jumps to 0 where the distance is clamped (≤ eps of the dtype),
    so pairs closer than ten f32 epsilons are left out there."""
    rng = np.random.default_rng(dim)
    x64 = torch.as_tensor(rng.normal(size=(700, dim)), device=cuda_device)
    y64 = torch.as_tensor(rng.normal(size=(500, dim)), device=cuda_device)
    x, y = x64.to(dtype), y64.to(dtype)
    out = []
    for fn, dt in ((tkm.kernelmatrix, dtype), (tkm.kernelmatrix_plain, torch.float64)):
        xx, yy = x.to(dt), y.to(dt)
        v = torch.tensor(1.3, dtype=dt, device=cuda_device, requires_grad=True)
        kern.reset_counters()
        first = _jvp_ones(lambda b: fn(xx, b, kind, v), yy)
        nested = _jvp_ones(lambda a: _jvp_ones(lambda b: fn(a, b, kind, v), yy), xx)
        (g,) = torch.autograd.grad(nested.sum(), v)
        if fn is tkm.kernelmatrix:
            assert kern.COUNTERS["kernelmatrix"].total == 2
        out.append((first.detach().double(), nested.detach().double(), g.double()))
    far = torch.cdist(x.double(), y.double(), compute_mode="donot_use_mm_for_euclid_dist") > (
        10 * torch.finfo(torch.float32).eps if kind != "se" else -1.0)
    # fp32: exp and FMA rounding on derivative values of order 1
    atol = 2e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=atol)
    torch.testing.assert_close(out[0][1] * far, out[1][1] * far, rtol=0, atol=atol)
    if kind == "se":
        torch.testing.assert_close(out[0][2], out[1][2], rtol=atol, atol=0)


def test_gradient_enhanced_step_at_4096_launches_the_kernels(cuda_device):
    """The derivative path at N = 4096 (f and f′ at 2048 points each): the
    blocked factor (kernels 2 and 3) and kernel 1 for K_ff and the jvp
    primals; value against f64 on the card (1e-4 relative), gradient within
    2e-2 of its largest component: its noise component cancels two terms of
    order N/σ² (the library's f32 factor's error is computed beside it for
    the message).  At σ² = 1, where f32 resolves every component, each of
    v, l and the noise is held to 1e-3 of its own f64 value."""
    data = entry.derivative_data(4096, 64, torch.float32, cuda_device)
    kern.reset_counters()
    val, grad = entry.derivative_step(data[4], data[:3])
    torch.cuda.synchronize()
    counts = {k: c.total for k, c in kern.COUNTERS.items()}
    assert counts["kernelmatrix"] >= 4, counts
    assert counts["chol_block"] > 0 and counts["tri_inv_block"] > 0, counts
    d64 = tuple(t.double() for t in data[:3])
    val64, grad64 = entry.derivative_step({k: v.double() for k, v in data[4].items()}, d64)
    np.testing.assert_allclose(val.item(), val64.item(), rtol=1e-4)
    with stt.config.chol_backend("torch"):
        _, lib_grad = entry.derivative_step(data[4], data[:3])
    g64 = np.array([grad64[k].item() for k in grad64])

    def err(gr):
        return np.max(np.abs(np.array([gr[k].item() for k in grad64]) - g64)) / np.max(np.abs(g64))

    assert err(grad) <= 2e-2, (err(grad), err(lib_grad))
    th1 = dict(data[4], noise=torch.tensor(1.0, device=cuda_device))
    g1 = entry.derivative_step(th1, data[:3])[1]
    g1_64 = entry.derivative_step({k: v.double() for k, v in th1.items()}, d64)[1]
    for k in g1_64:
        assert abs(g1[k].item() - g1_64[k].item()) <= 1e-3 * abs(g1_64[k].item()), (k, g1, g1_64)


def test_blocked_factor_backward_error_is_the_librarys(cuda_device):
    """The f32 blocked factor of the gradient-enhanced GP's N = 16384
    covariance (condition about 2.4e5): its backward error ‖LLᵀ − K‖_F /
    ‖K‖_F, in f64, within 1.5× of cuSOLVER's.  Summed in one GEMM over all
    earlier columns, the left-looking update read 3.7× cuSOLVER's on an
    H100 (`stheno_tpu_torch/accuracy_probe.py`); panel by panel, 0.7×."""
    xf, xd, y, xp, theta = entry.derivative_data(16384, 64, torch.float32, cuda_device)
    with torch.no_grad():
        K = entry.derivative_observation(theta, (xf, xd)).cov()
        K64 = torch.tril(K).double()
        K64 = K64 + torch.tril(K64, -1).mT

        def bwd_err(L):
            L64 = L.double()
            return ((L64 @ L64.mT - K64).norm() / K64.norm()).item()

        kern.reset_counters()
        blocked = bwd_err(tchol.cholesky_psd(K))
        assert kern.COUNTERS["chol_block"].total > 0
        with stt.config.chol_backend("torch"):
            library = bwd_err(tchol.cholesky_psd(K))
    assert blocked <= 1.5 * library, (blocked, library)


def test_sharded_logpdf_on_a_one_rank_nccl_mesh_at_4096(cuda_device):
    """The distributed route (`parallel.sharded_logpdf`: the slab from
    kernel 1, the cyclic panel loop, the collectives) on a one-rank NCCL
    'rows' mesh equals the single-card flagship value to 1e-4."""
    import torch.distributed as dist

    from stheno_tpu_torch.parallel import collectives as coll
    from stheno_tpu_torch.parallel import rows_mesh, sharded_logpdf

    made = not dist.is_initialized()
    try:
        mesh = rows_mesh()
        assert dist.get_backend() == "nccl" and mesh.size() == 1
        x, y, _, theta = entry.flagship_data(4096, 1, torch.float32, cuda_device)
        kern.reset_counters()
        coll.reset_counters()
        with torch.no_grad():
            val = -sharded_logpdf(mesh, entry.build(theta)(stt.GPPPInput("f3", x), theta["noise"]), y)
        assert kern.COUNTERS["kernelmatrix"].total > 0 and coll.total_calls() > 0
        step, th = entry.flagship(4096, torch.float32, cuda_device)
        ref, _ = step(th)
        assert abs(val.item() - ref.item()) <= 1e-4 * abs(ref.item())
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def test_vmapped_kernelmatrix_backward_under_plain_autograd(cuda_device):
    """The convolutional GP's `var2` vmaps kernel 1 and is differentiated by
    ordinary autograd: the batched launch at D = 9 must carry the gradient
    to x, y and σ², equal to the loop over single launches (f64)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(8, 36, 9, generator=gen, dtype=torch.float64, device=cuda_device,
                    requires_grad=True)
    y = torch.randn(8, 36, 9, generator=gen, dtype=torch.float64, device=cuda_device,
                    requires_grad=True)
    v = torch.tensor(1.3, dtype=torch.float64, device=cuda_device, requires_grad=True)
    kern.reset_counters()
    K = torch.func.vmap(lambda a, b: tkm.kernelmatrix(a, b, "se", v))(x, y)
    assert kern.COUNTERS["kernelmatrix_batched"].total == 1
    got = torch.autograd.grad(K.sum(dim=(1, 2)).square().sum(), (x, y, v))
    K1 = torch.stack([tkm.kernelmatrix(x[i], y[i], "se", v) for i in range(8)])
    want = torch.autograd.grad(K1.sum(dim=(1, 2)).square().sum(), (x, y, v))
    for g, h in zip(got, want):
        torch.testing.assert_close(g, h, rtol=1e-12, atol=1e-12 * float(h.abs().max()))


def test_rand_with_a_cpu_generator_draws_the_cpus_numbers(cuda_device):
    """A CPU `torch.Generator` draws on the CPU and moves the draw: the card
    samples what the CPU samples from the same seed (the examples rely on
    it), to the two factors' rounding."""
    x = torch.linspace(-3.0, 3.0, 50, dtype=torch.float64)
    f = stt.GP(stt.SEKernel(), gpc=stt.GPC())
    on_cpu = stt.rand(torch.Generator().manual_seed(4), f(x, 0.05), 3)
    on_card = stt.rand(torch.Generator().manual_seed(4), f(x.to(cuda_device), 0.05), 3)
    assert on_card.device.type == "cuda"
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-10, atol=1e-10)


def _hold_vjp(x, y, kind, v, K_bar):
    """The VJP kernel against `kernelmatrix_vjp` on the same inputs: each
    output within 1e-5 (f32) or 1e-12 (f64) of its terms' Σ|·| in f64 (sums
    of up to a few thousand terms here, added in another order)."""
    got = tkm._launch_vjp(x, y, kind, v, K_bar)
    want = tkm.kernelmatrix_vjp(x, y, kind, v, K_bar)
    f64 = lambda t: None if t is None else t.double()
    scale = tkm.kernelmatrix_vjp_abs_terms(f64(x), f64(y), kind, v.double(), K_bar.double())
    tol = 1e-5 if x.dtype == torch.float32 else 1e-12
    for name, g, w, sc in zip(("x", "y", "variance"), got, want, scale):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.shape == w.shape and g.dtype == w.dtype, name
            assert bool(((g.double() - w.double()).abs() <= tol * sc).all()), (name, kind, tuple(x.shape))
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", sorted(tkm.KINDS))
def test_kernelmatrix_vjp_matches_plain(cuda_device, kind, dtype):
    """The VJP kernel at D = 1, 2, 4, 9 (compiled) and 17 (rows-only, run
    twice), same-input and cross, ragged N and M (300 × 177: rows of the
    cotangent off a 16-byte boundary), and one launch counted each."""
    rng = np.random.default_rng(12)
    for dim in (1, 2, 4, 9, 17):
        ell = np.linspace(0.7, 2.1, dim) * np.sqrt(dim)
        x = torch.as_tensor(rng.normal(size=(300, dim)) / ell, dtype=dtype, device=cuda_device)
        y = torch.as_tensor(rng.normal(size=(177, dim)) / ell, dtype=dtype, device=cuda_device)
        v = torch.tensor(1.7, dtype=dtype, device=cuda_device)
        for yy in (None, y):
            m = 300 if yy is None else 177
            K_bar = torch.as_tensor(rng.normal(size=(300, m)), dtype=dtype, device=cuda_device)
            kern.reset_counters()
            _hold_vjp(x, yy, kind, v, K_bar)
            assert kern.COUNTERS["kernelmatrix_vjp"].by_shape == {(1, 300, m, dim, yy is None): 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernelmatrix_vjp_batched_with_shared_operands(cuda_device, dtype):
    """The batched VJP (C = 5) with x, y, σ² and K̄ each shared by the batch
    (expanded views, batch stride 0) and not, against the plain version."""
    gen = torch.Generator(device="cpu").manual_seed(13)
    for dim in (1, 9):
        x = (torch.randn(5, 130, dim, generator=gen, dtype=torch.float64) * 2).to(cuda_device, dtype)
        y = (torch.randn(5, 67, dim, generator=gen, dtype=torch.float64) * 2).to(cuda_device, dtype)
        v = (torch.rand(5, generator=gen, dtype=torch.float64) + 0.5).to(cuda_device, dtype)
        Kb = torch.randn(5, 130, 67, generator=gen, dtype=torch.float64).to(cuda_device, dtype)
        for kind in ("se", "matern32"):
            _hold_vjp(x, y, kind, v, Kb)
            _hold_vjp(x[0].expand(5, 130, dim), y, kind, v[0].expand(5), Kb)
            _hold_vjp(x, y[0].expand(5, 67, dim), kind, v, Kb[0].expand(5, 130, 67))
            Ks = torch.randn(5, 130, 130, generator=gen, dtype=torch.float64).to(cuda_device, dtype)
            _hold_vjp(x, None, kind, v, Ks)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernelmatrix_vjp_takes_cotangents_as_autograd_hands_them_over(cuda_device, dtype):
    """K̄ expanded from a scalar (strides 0, 0), a transposed view, and a
    slice of a wider cotangent (row stride past M; a start on and off a
    16-byte boundary), each read in place, same-input and cross; all but
    the transposed one give the bits of a contiguous copy."""
    gen = torch.Generator(device="cpu").manual_seed(14)
    rand = lambda *shape: torch.randn(*shape, generator=gen, dtype=torch.float64).to(cuda_device, dtype)
    x, y = rand(257, 4), rand(132, 4)
    v = torch.tensor(0.8, dtype=dtype, device=cuda_device)

    def layouts(n, m):
        wide = rand(n, m + 8)
        return {"scalar": torch.ones((), dtype=dtype, device=cuda_device).expand(n, m),
                "transposed": rand(m, n).T, "slice": wide[:, 4:m + 4], "slice off 16 bytes": wide[:, 1:m + 1]}

    for kind in sorted(tkm.KINDS):
        for yy, m in ((y, 132), (None, 257)):
            for label, K_bar in layouts(257, m).items():
                got = _hold_vjp(x, yy, kind, v, K_bar)
                if label != "transposed":  # the transposed problem adds in another order
                    ref = tkm._launch_vjp(x, yy, kind, v, K_bar.contiguous())
                    for g, r in zip(got, ref):
                        assert (g is None and r is None) or torch.equal(g, r), (label, kind)


def test_kernelmatrix_vjp_repeats_bit_for_bit(cuda_device):
    """No floating-point atomics: two calls give the same bits, unbatched
    and batched, f32 and f64, at a shape with many CTAs a row."""
    gen = torch.Generator(device="cpu").manual_seed(15)
    for dtype in (torch.float32, torch.float64):
        x = torch.randn(2048, 2, generator=gen, dtype=torch.float64).to(cuda_device, dtype)
        Kb = torch.randn(2048, 2048, generator=gen, dtype=torch.float64).to(cuda_device, dtype)
        v = torch.tensor(1.3, dtype=dtype, device=cuda_device)
        xb = torch.randn(16, 300, 9, generator=gen, dtype=torch.float64).to(cuda_device, dtype)
        Kbb = torch.randn(16, 300, 300, generator=gen, dtype=torch.float64).to(cuda_device, dtype)
        vb = torch.rand(16, generator=gen, dtype=torch.float64).to(cuda_device, dtype)
        for args in ((x, None, "matern52", v, Kb), (x, x.flip(0), "se", v, Kb),
                     (xb, None, "se", vb, Kbb)):
            first = tkm._launch_vjp(*args)
            for _ in range(10):
                again = tkm._launch_vjp(*args)
                for g, h in zip(first, again):
                    assert (g is None and h is None) or torch.equal(g, h)


def test_second_backward_through_the_card_route_raises(cuda_device):
    """The card's reverse rule is once differentiable: a second
    differentiation through it raises, whichever input carries the graph
    (never a silent zero), for the unbatched and the batched launch; the
    first derivative under `create_graph=True` is the plain one."""
    x = torch.linspace(-2.0, 2.0, 64, dtype=torch.float64, device=cuda_device)[:, None]
    x = x.clone().requires_grad_(True)
    v = torch.tensor(1.2, dtype=torch.float64, device=cuda_device, requires_grad=True)
    K = tkm.kernelmatrix(x, None, "se", v)
    (gx,) = torch.autograd.grad(K.sum(), x, create_graph=True)  # K̄: a scalar, no graph
    ref = tkm.kernelmatrix_vjp(x.detach(), None, "se", v.detach(), torch.ones_like(K))[0]
    torch.testing.assert_close(gx.detach(), ref, rtol=1e-12, atol=1e-12)
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad((gx * gx).sum(), (x, v))
    xb = torch.randn(3, 40, 2, dtype=torch.float64, device=cuda_device, requires_grad=True)
    Kb = torch.func.vmap(lambda a: tkm.kernelmatrix(a, None, "matern32", v))(xb)
    (gb,) = torch.autograd.grad(Kb.square().sum(), xb, create_graph=True)
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(gb.sum(), v)


def test_vjp_counter_counts_each_backward_and_no_cpu_call(cuda_device):
    """One VJP launch for each backward through kernel 1 on the card (two
    for a sum of two kernels), none on CPU tensors; and on the card the
    plain `kernelmatrix_vjp` is never reached."""
    calls = []
    plain = tkm.kernelmatrix_vjp

    def spy(x, *args, **kwargs):
        calls.append(x.device.type)
        return plain(x, *args, **kwargs)

    tkm.kernelmatrix_vjp = spy
    try:
        for device in (cuda_device, torch.device("cpu")):
            x = torch.linspace(-3.0, 3.0, 200, device=device)[:, None].requires_grad_(True)
            v = torch.tensor(0.9, device=device, requires_grad=True)
            kern.reset_counters()
            K = tkm.kernelmatrix(x, None, "se", v) + tkm.kernelmatrix(x / 2, None, "matern32", v)
            torch.autograd.grad((K * K).sum(), (x, v))
            expected = 2 if device.type == "cuda" else 0
            assert kern.COUNTERS["kernelmatrix_vjp"].total == expected
    finally:
        tkm.kernelmatrix_vjp = plain
    assert calls == ["cpu", "cpu"]


# ---- the TF32 split and the GEMM precisions ---------------------------------------


def _edge_f32(n, seed, device):
    """Random bits (every exponent, NaNs and infinities among them), then
    ties, subnormals, ±0, ±inf, NaN and values whose rounding overflows."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    bits = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, dtype=torch.int64).to(torch.int32)
    edge = [0x00000000, 0x80000000, 0x00000001, 0x00001000, 0x00001FFF, 0x007FFFFF, 0x3F801000,
            0xBF801000, 0x3F803000, 0x3F800FFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7FF000, 0x7F7FEFFF,
            0x7F800000, 0xFF800000, 0x7FC00000, 0xFFA00001]
    edge = torch.tensor([b - (1 << 32) if b >= 1 << 31 else b for b in edge], dtype=torch.int32)
    return torch.cat([bits, edge]).view(torch.float32).to(device)


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def test_tf32_split_matches_plain_bit_for_bit(cuda_device):
    from stheno_tpu_torch.cuda import tf32_split as ts

    x = _edge_f32((1 << 20) + 2, 20, cuda_device)  # + 18 edge values: not a multiple of 4
    kern.reset_counters()
    for v in (x, x[:1 << 20].view(1024, 1024), x[:1 << 20].view(4, 512, 512)):
        hi, lo = ts.tf32_split(v)
        ph, pl = ts.tf32_split_plain(v)
        assert hi.shape == v.shape and _same_bits(hi, ph) and _same_bits(lo, pl)
    X = x[:1 << 20].view(1024, 1024)
    for v in (X[:, 3:1000], X[:, 4:1000], X.T, X[:512, 8:].T):  # read in place, by their strides
        hi, lo = ts.tf32_split(v)
        ph, pl = ts.tf32_split_plain(v)
        assert hi.shape == v.shape and _same_bits(hi, ph) and _same_bits(lo, pl)
    torch.cuda.synchronize()
    assert kern.COUNTERS["tf32_split"].total == 7
    with pytest.raises(TypeError):
        ts.tf32_split(x.double())


def test_products_against_f64_on_the_card(cuda_device):
    """At each precision against f64, normalised by max(|A||B|): 'high'
    (3xTF32) within 4× fp32's own error, 'default' (one TF32 pass) within
    1e-3, on normal data; the split runs only at 'high'."""
    from stheno_tpu_torch import config
    from stheno_tpu_torch.ops import blocked_cholesky as bc

    g = torch.Generator(device=cuda_device).manual_seed(21)
    for m, k, n in ((4096, 1024, 1024), (1024, 8192, 1024)):
        A = torch.randn(m, k, generator=g, device=cuda_device)
        B = torch.randn(k, n, generator=g, device=cuda_device)
        ref = A.double() @ B.double()
        scale = (A.double().abs() @ B.double().abs()).max().item()
        err = {}
        for p in ("highest", "high", "default"):
            kern.reset_counters()
            with config.gemm_precision(p):
                err[p] = (bc._mm(A, B).double() - ref).abs().max().item() / scale
            torch.cuda.synchronize()
            assert (kern.COUNTERS["tf32_split"].total > 0) == (p == "high"), p
        assert err["high"] <= 4 * err["highest"], err
        assert err["default"] <= 1e-3 and err["default"] > 10 * err["highest"], err
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_tf32_switch_is_restored_after_a_scope(cuda_device):
    from stheno_tpu_torch import config
    from stheno_tpu_torch.ops import blocked_cholesky as bc

    A = torch.randn(256, 256, device=cuda_device)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    for p in ("high", "default"):
        with config.gemm_precision(p):
            bc._mm(A, A)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        with pytest.raises(RuntimeError, match="on purpose"):
            with config.gemm_precision(p), bc._tf32():
                assert torch.backends.cuda.matmul.allow_tf32 is True
                raise RuntimeError("on purpose")
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_dry_run_on_a_one_rank_nccl_grid(cuda_device):
    """`multichip.dryrun_multichip` on a one-rank NCCL group: every value
    finite, kernel 1 launched and collectives called on each stage."""
    import torch.distributed as dist

    from stheno_tpu_torch.multichip import dryrun_multichip

    assert not dist.is_initialized()
    out = dryrun_multichip()
    assert not dist.is_initialized()  # the group it made is gone
    assert out["mesh"] == {"chains": 1, "rows": 1} and out["chains"] == 2
    for k in ("logps", "grads", "q", "logp", "accept_prob", "m1", "v1", "svgp_dq_mu", "svgp_dq_sqrt"):
        assert bool(torch.isfinite(out[k]).all()), k
    for k in ("logp_first", "gppp_lp", "gppp_dlp_dv", "ring_lp", "ring_dlp_dl", "neg_elbo"):
        assert np.isfinite(out[k]), k
    for stage in ("nuts", "gppp", "ring", "svgp"):
        assert out["launches"][stage]["kernelmatrix"] > 0, stage
        assert sum(out["collectives"][stage].values()) > 0, stage
    assert out["launches"]["nuts"]["kernelmatrix_vjp"] > 0


def test_nuts_bench_segmented_equals_unsegmented_on_the_card(cuda_device, tmp_path):
    from stheno_tpu_torch import nuts_bench

    small = ["--n", "512", "--chains", "4", "--warmup", "12", "--samples", "8", "--max-depth", "5"]
    draws = {}
    for name, extra in (("whole", []), ("seg", ["--segment", "3", "--single-pass"])):
        kern.reset_counters()
        line = nuts_bench.main(small + extra + ["--save-draws", str(tmp_path / f"{name}.npz")])
        assert kern.COUNTERS["kernelmatrix_batched"].total > 0
        assert "," in line["device"]  # the card's name, its power limit
        draws[name] = np.load(tmp_path / f"{name}.npz")
    for k in ("draws_v", "draws_l", "draws_noise", "div"):
        np.testing.assert_array_equal(draws["seg"][k], draws["whole"][k])

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
    ell = np.asarray([0.7, 1.3, 2.1])
    for dim in (1, 3):
        xs = torch.as_tensor(rng.normal(size=(1000, dim)) / ell[:dim], dtype=dtype, device=cuda_device)
        ys = torch.as_tensor(rng.normal(size=(777, dim)) / ell[:dim], dtype=dtype, device=cuda_device)
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
        "kernelmatrix": 1, "kernelmatrix_batched": 0, "chol_block": 1, "tri_inv_block": 1,
        "km_se_d1": 1}
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
    assert counts == {"kernelmatrix": 0, "kernelmatrix_batched": 1, "chol_block": 0,
                      "tri_inv_block": 0, "km_se_d1": 0}, counts
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

"""The extension contract on the port: a user-defined process class
(`AbstractProcess` with its statistics and cross rules) composes with
sums, scalings, GPPP routing, posteriors and VFE.  The two user processes
of the examples, `custom_affine_transformations.AGP` and
`convolutional_gp.PatchConvolveGP`, against the JAX examples' classes in
f64 on common numpy inputs: every statistic and cross rule to 1e-10, the
logpdf (or ELBO) and its gradient to 1e-10 relative, and
`utils.testing.check_process_interface` on the port's classes.

Besides, the fault the convolutional GP's `var2` showed in kernel 1's
`vmap` rule: under `torch.func.vmap` with ordinary autograd (a
`backward()` through a statistic that vmaps `kernelmatrix`), the batched
launch must carry the gradient.
"""

import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as st
import stheno_tpu_torch as stt
from stheno_tpu.graph import cross_cov as jcross_cov
from stheno_tpu.graph import cross_var as jcross_var
from stheno_tpu_torch.cuda import kernelmatrix as km
from stheno_tpu_torch.examples import convolutional_gp as TC
from stheno_tpu_torch.examples import custom_affine_transformations as TA
from stheno_tpu_torch.graph import cross_cov, cross_var
from stheno_tpu_torch.utils.testing import check_process_interface
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-10
F64 = torch.float64


def jax_example(name):
    return runpy.run_path(str(REPO / "examples" / f"{name}.py"), run_name=f"jax_example_{name}")


def t(a):
    return torch.tensor(np.ascontiguousarray(a), dtype=F64)


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-300))


# --- row 5: (Af)(x) = f(x) + f(x + 3) − 2 -------------------------------------


def test_custom_affine_statistics_and_cross_rules_match_the_reference():
    J = jax_example("custom_affine_transformations")
    rng = np.random.default_rng(1)
    x, x2 = rng.normal(size=5), rng.normal(size=7)
    jg, tg = J["model"](), TA.model()
    jf, jA, tf, tA = jg["f"], jg["Af"], tg["f"], tg["Af"]
    jx, jx2, tx, tx2 = jnp.asarray(x), jnp.asarray(x2), t(x), t(x2)
    jr, tr = jnp.asarray(x[::-1]), t(x[::-1])  # a second input of x's length
    close(tA.mean(tx), jA.mean(jx))
    close(tA.cov(tx), jA.cov(jx))
    close(tA.cov2(tx, tx2), jA.cov2(jx, jx2))
    close(tA.var(tx), jA.var(jx))
    close(tA.var2(tx, tr), jA.var2(jx, jr))
    # Af on the left (its _cross_*_l) and on the right (_cross_*_r) of f
    close(cross_cov(tA, tf, tx, tx2), jcross_cov(jA, jf, jx, jx2))
    close(cross_cov(tf, tA, tx, tx2), jcross_cov(jf, jA, jx, jx2))
    close(tA._cross_cov_l(tf, tx, tx2), jA._cross_cov_l(jf, jx, jx2))
    close(tA._cross_cov_r(tf, tx, tx2), jA._cross_cov_r(jf, jx, jx2))
    close(tA._cross_var_l(tf, tx, tr), jA._cross_var_l(jf, jx, jr))
    close(tA._cross_var_r(tf, tx, tr), jA._cross_var_r(jf, jx, jr))
    close(cross_var(tf, tA, tx, tr), jcross_var(jf, jA, jx, jr))
    # the composites the example builds
    jh, th = 2.0 * jA + jf, 2.0 * tA + tf
    close(th.cov2(tx, tx2), jh.cov2(jx, jx2))
    close(cross_cov(th, tA, tx, tx2), jcross_cov(jh, jA, jx, jx2))


def test_custom_affine_logpdf_and_posterior_match_the_reference():
    """Af observed at 20 points: the logpdf and its gradient in (y, noise),
    and the posterior of f read off at the same points, through GPPP
    routing."""
    J = jax_example("custom_affine_transformations")
    rng = np.random.default_rng(2)
    xo, y = np.sort(rng.uniform(-3, 3, 20)), rng.normal(size=20)
    jg, tg = J["model"](), TA.model()
    jlp = jax.value_and_grad(
        lambda yy, s: st.logpdf(jg(st.GPPPInput("Af", jnp.asarray(xo)), s), yy), argnums=(0, 1))
    jv, (jgy, jgs) = jlp(jnp.asarray(y), 0.1)
    ty, ts = t(y).requires_grad_(True), torch.tensor(0.1, dtype=F64, requires_grad=True)
    tv = stt.logpdf(tg(stt.GPPPInput("Af", t(xo)), ts), ty)
    tgy, tgs = torch.autograd.grad(tv, (ty, ts))
    close(tv, jv)
    close(tgy, jgy)
    close(tgs, jgs)
    jpost = st.posterior(jg(st.GPPPInput("Af", jnp.asarray(xo)), 0.1), jnp.asarray(y))
    tpost = stt.posterior(tg(stt.GPPPInput("Af", t(xo)), 0.1), t(y))
    q = [("f", xo), ("Af", xo[::2])]
    jq = st.BlockData(*(st.GPPPInput(p, jnp.asarray(v)) for p, v in q))
    tq = stt.BlockData(*(stt.GPPPInput(p, t(v)) for p, v in q))
    close(tpost.mean(tq), jpost.mean(jq))
    close(tpost.var(tq), jpost.var(jq))


def test_custom_affine_passes_the_interface_checks():
    """`check_process_interface` as the example calls it, on the port's
    classes: the node, the programme over a `BlockData` and a composite."""
    rng = np.random.default_rng(0)
    g = TA.model()
    x, x2 = t(rng.normal(size=5)), t(rng.normal(size=7))
    check_process_interface(g["Af"], x, t(rng.normal(size=5)), x2, f2=g["f"])
    check_process_interface(g, stt.GPPPInput("Af", x), stt.GPPPInput("Af", t(rng.normal(size=5))),
                            stt.BlockData(stt.GPPPInput("f", x2), stt.GPPPInput("Af", x)))
    check_process_interface(2.0 * g["Af"] + g["f"], x, t(rng.normal(size=5)), f2=g["Af"])


# --- row 6: the convolutional GP ---------------------------------------------


def _images(seed, n, h=8):
    return TC.smooth_images(np.random.default_rng(seed), n, h)


def test_unfold_patches_match_conv_general_dilated_patches():
    J = jax_example("convolutional_gp")
    imgs = np.random.default_rng(3).normal(size=(3, 7, 9))
    got = TC.extract_patches(t(imgs))
    assert tuple(got.shape) == (3, 5 * 7, 9)
    close(got, J["extract_patches"](jnp.asarray(imgs)), rtol=0)
    # the first patch of the first image, row-major
    np.testing.assert_array_equal(got[0, 0].numpy(), imgs[0, :3, :3].ravel())


@pytest.mark.parametrize("chunk", [None, 2])
def test_patch_convolve_statistics_and_cross_rules_match_the_reference(chunk):
    """Every statistic and cross rule of `PatchConvolveGP` (with and without
    image chunks) against the JAX class, at var 1.3 and l 0.8.  The
    reference's `_cross_var_l` sums over the images rather than the patch
    positions (it returns one number a patch), so the port's is held to the
    diagonal of the reference's `_cross_cov_l` instead."""
    J = jax_example("convolutional_gp")
    theta = dict(var=1.3, l=0.8)
    jg = J["build_gp"]({k: jnp.asarray(v) for k, v in theta.items()})
    tg = TC.build_gp({k: torch.tensor(v, dtype=F64) for k, v in theta.items()}, chunk)
    jf, jp, tf, tp = jg["f"], jg["g"], tg["f"], tg["g"]
    a, b = _images(0, 5), _images(1, 5)
    z = np.random.default_rng(2).normal(size=(6, 9))
    ja, jb, jz, ta, tb, tz = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(z), t(a), t(b), t(z))
    close(tf.mean(ta), jf.mean(ja))
    close(tf.cov(ta), jf.cov(ja))
    close(tf.cov2(ta, tb), jf.cov2(ja, jb))
    close(tf.var(ta), jf.var(ja))
    close(tf.var2(ta, tb), jf.var2(ja, jb))
    close(tf._cross_cov_l(tp, ta, tz), jf._cross_cov_l(jp, ja, jz))
    close(tf._cross_cov_r(tp, tz, ta), jf._cross_cov_r(jp, jz, ja))
    close(cross_cov(tp, tf, tz, ta), jcross_cov(jp, jf, jz, ja))
    zp = z[:5]  # paired with the 5 images
    close(tf._cross_var_r(tp, t(zp), ta), jf._cross_var_r(jp, jnp.asarray(zp), ja))
    close(tf._cross_var_l(tp, ta, t(zp)), jnp.diagonal(jf._cross_cov_l(jp, ja, jnp.asarray(zp))))
    close(cross_var(tf, tp, ta, t(zp)), jnp.diagonal(jcross_cov(jf, jp, ja, jnp.asarray(zp))))


def test_patch_convolve_brute_force_entry_and_elbo_match_the_reference():
    """K[0, 1] against the patch-pair sum (the example's oracle) and the
    reference's; the patch-space VFE −ELBO and its gradient in (var, l),
    and the exact logpdf, against the reference's."""
    J = jax_example("convolutional_gp")
    imgs = _images(0, 12)
    rng = np.random.default_rng(4)
    z, y = rng.normal(size=(32, 9)), rng.normal(size=12)
    tg = TC.build_gp(dict(var=1.0, l=1.0))
    K = tg["f"].cov(t(imgs))
    k01 = TC.k01_brute_force(tg["g"], TC.extract_patches(t(imgs)))
    assert abs(K[0, 1].item() - k01) <= 1e-12 * abs(k01)
    close(K, J["build_gp"](dict(var=1.0, l=1.0))["f"].cov(jnp.asarray(imgs)))

    def jneg(var, l):  # noqa: E741
        f = J["build_gp"](dict(var=var, l=l))
        return -st.elbo(st.VFE(f(st.GPPPInput("g", jnp.asarray(z)), 1e-6)),
                        f(st.GPPPInput("f", jnp.asarray(imgs)), 0.1), jnp.asarray(y))

    jv, jgr = jax.value_and_grad(jneg, argnums=(0, 1))(1.3, 0.8)
    th = {"var": torch.tensor(1.3, dtype=F64, requires_grad=True),
          "l": torch.tensor(0.8, dtype=F64, requires_grad=True)}
    tv = TC.neg_elbo(th, t(imgs), t(z), t(y))
    tgr = torch.autograd.grad(tv, [th["var"], th["l"]])
    close(tv, jv)
    close(torch.stack(tgr), np.asarray(jgr))
    jf = J["build_gp"](dict(var=1.3, l=0.8))
    close(stt.logpdf(TC.build_gp(dict(var=1.3, l=0.8))(stt.GPPPInput("f", t(imgs)), 0.1), t(y)),
          st.logpdf(jf(st.GPPPInput("f", jnp.asarray(imgs)), 0.1), jnp.asarray(y)))


def test_patch_convolve_chunks_keep_the_elbo_and_its_gradient():
    """The full-width run's image chunks change nothing but the memory."""
    imgs, z, y = TC.full_data(10, 8, 16, F64, "cpu")
    grads = []
    for chunk in (None, 3):
        th = {"var": torch.tensor(1.3, dtype=F64, requires_grad=True),
              "l": torch.tensor(0.8, dtype=F64, requires_grad=True)}
        v = TC.neg_elbo(th, imgs, z, y, chunk=chunk)
        grads.append(torch.stack([v, *torch.autograd.grad(v, [th["var"], th["l"]])]))
    close(grads[1], grads[0].detach().numpy(), rtol=1e-13)


def test_patch_convolve_passes_the_interface_checks():
    """`check_process_interface` on the port's image process, its cross
    rules against a second patch-sum node of the same g (which reach
    `_cross_cov_l/_r` and `_cross_var_l/_r`, nested under `vmap`)."""
    @stt.gppp
    def build():
        g = stt.GP(1.3 * stt.with_lengthscale(stt.SEKernel(), 0.8))
        return dict(g=g, f=TC.patch_convolve(g), h=TC.patch_convolve(g, chunk=2))

    prog = build()
    a, b, c = t(_images(0, 4)), t(_images(1, 4)), t(_images(2, 3))
    check_process_interface(prog["f"], a, b, c, f2=prog["h"])
    check_process_interface(prog["h"], a, b, c, f2=prog["f"])


# --- kernel 1's vmap rule under ordinary autograd ------------------------------


def test_vmapped_kernelmatrix_carries_the_gradient_under_plain_autograd(monkeypatch):
    """The card's batched launch is invisible to autograd (a ctypes call);
    here the plain batched version is made so too.  A `backward()` through
    `torch.func.vmap(kernelmatrix)` must still reach x, y and σ², equal to
    the loop over the batch's single calls: the batched launch records its
    own autograd node (`_KernelMatrixBatched`)."""
    forward = km.kernelmatrix_batched_forward

    def opaque(*args):
        with torch.no_grad():
            return forward(*args)

    monkeypatch.setattr(km, "kernelmatrix_batched_forward", opaque)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 9, generator=gen, dtype=F64, requires_grad=True)
    y = torch.randn(3, 4, 9, generator=gen, dtype=F64, requires_grad=True)
    v = torch.tensor(1.3, dtype=F64, requires_grad=True)
    w = torch.randn(3, 5, 4, generator=gen, dtype=F64)
    for kind in ("se", "matern52"):
        K = torch.func.vmap(lambda a, b: km.kernelmatrix(a, b, kind, v))(x, y)
        got = torch.autograd.grad((K * w).sum(), (x, y, v))
        K1 = torch.stack([km.kernelmatrix(x[i], y[i], kind, v) for i in range(3)])
        want = torch.autograd.grad((K1 * w).sum(), (x, y, v))
        for g, h in zip(got, want):
            close(g, h.numpy(), rtol=1e-13)

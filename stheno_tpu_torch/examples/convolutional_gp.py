"""The convolutional Gaussian process (`examples/convolutional_gp.py`) on
the port: a user-defined process `PatchConvolveGP` sums a patch-space GP
g over every 3 × 3 patch of a greyscale image, a GP over images; inducing
points then live in the 9-dimensional patch space (interdomain VFE).

Every statistic flattens the patches of all images into one (N·P, 9)
array, makes one kernel matrix of it and block-sums it.  The paired
diagonals map the parent's statistic with `torch.func.vmap`, over the
images (`var2`) or over the patch positions (`_cross_var_l/_r`); `var2`
thus reaches kernel 1's `vmap` rule, one batched launch at (N, P, P),
D = 9, in place of N launches.  With `chunk` set, each statistic
runs over that many images at a time under one autograd graph, so no
(N·P, ·) block is held whole (the full-width run of `chip_smoke.py`).

    python -m stheno_tpu_torch.examples.convolutional_gp [--device cpu]

As in the reference, smooth random images stand in for MNIST.  The
observations are a draw from a CPU `torch.Generator` seeded 3, the reference's
key number; the images and inducing points come from numpy's
`default_rng(0)`.
"""

from __future__ import annotations

import numpy as np
import torch

from stheno_tpu_torch import VFE, GPPPInput, elbo, logpdf, rand
from stheno_tpu_torch.convert import resolve_device
from stheno_tpu_torch.examples._common import check, run_cli, tensor
from stheno_tpu_torch.gppp import gppp
from stheno_tpu_torch.graph import GP, GPC, AbstractProcess, cross_cov, cross_var
from stheno_tpu_torch.kernels import SEKernel, with_lengthscale
from stheno_tpu_torch.tree import frozen_dataclass, static_field

PATCH = 3


def extract_patches(ximg):
    """(N, H, W) images → (N, P, 9) patch vectors, P = (H − 2)(W − 2):
    `unfold` orders both the 9 coordinates and the P patches row-major, as
    `jax.lax.conv_general_dilated_patches` does in NCHW."""
    p = torch.nn.functional.unfold(ximg[:, None], kernel_size=PATCH)  # (N, 9, P)
    return p.transpose(1, 2)


def _flat_patches(ximg):
    pp = extract_patches(ximg)
    n, P, d = pp.shape
    return pp.reshape(n * P, d), n, P


def _chunks(x, chunk):
    """`x` in runs of `chunk` images (all of it when `chunk` is None)."""
    step = x.shape[0] if chunk is None else chunk
    return [x[i:i + step] for i in range(0, x.shape[0], step)]


@frozen_dataclass(eq=False)
class PatchConvolveGP(AbstractProcess):
    """f(img) = Σ_patches g(patch) (the derived op of script.jl:41-77).

    Inputs to this process are (N, H, W) image stacks; inputs to the parent
    `g` are (M, 9) patch vectors."""

    g: AbstractProcess
    n: int = static_field()
    gpc: GPC = static_field()
    chunk: object = static_field(default=None)

    def mean(self, x):
        return torch.cat([self._mean(xc) for xc in _chunks(x, self.chunk)])

    def _mean(self, x):
        xp, n, P = _flat_patches(x)
        return self.g.mean(xp).reshape(n, P).sum(dim=1)

    def cov2(self, x, x2):
        x2p, n2, P2 = _flat_patches(x2)
        rows = []
        for xc in _chunks(x, self.chunk):
            xp, n, P = _flat_patches(xc)
            rows.append(self.g.cov2(xp, x2p).reshape(n, P, n2, P2).sum(dim=(1, 3)))
        return torch.cat(rows)

    def cov(self, x):
        return self.cov2(x, x)

    def var(self, x):
        return self.var2(x, x)

    def var2(self, x, x2):
        # the diagonal of the block-summed matrix: each image's patch-pair
        # sum, O(N·P²), one batched kernel matrix per chunk
        return torch.cat([self._var2(xc, x2c) for xc, x2c
                          in zip(_chunks(x, self.chunk), _chunks(x2, self.chunk))])

    def _var2(self, x, x2):
        xp, n, P = _flat_patches(x)
        x2p, n2, P2 = _flat_patches(x2)
        Kii = torch.func.vmap(self.g.cov2)(xp.reshape(n, P, -1), x2p.reshape(n2, P2, -1))
        return Kii.sum(dim=(1, 2))

    # the cross rules distribute the patch sum into any other process
    def _cross_cov_l(self, f2, x, x2):
        rows = []
        for xc in _chunks(x, self.chunk):
            xp, n, P = _flat_patches(xc)
            rows.append(cross_cov(self.g, f2, xp, x2).reshape(n, P, -1).sum(dim=1))
        return torch.cat(rows)

    def _cross_cov_r(self, f2, x, x2):
        cols = []
        for x2c in _chunks(x2, self.chunk):
            x2p, n2, P2 = _flat_patches(x2c)
            K = cross_cov(f2, self.g, x, x2p)
            cols.append(K.reshape(K.shape[0], n2, P2).sum(dim=2))
        return torch.cat(cols, dim=1)

    def _cross_var_l(self, f2, x, x2):
        # over the patch index: each image's p-th patch against x2, then the
        # sum over p (the reference's rule sums over the images instead,
        # and returns one number a patch where the diagonal has one an image)
        xp, n, P = _flat_patches(x)
        v = torch.func.vmap(lambda xb: cross_var(self.g, f2, xb, x2))(
            xp.reshape(n, P, -1).transpose(0, 1))
        return v.sum(dim=0)

    def _cross_var_r(self, f2, x, x2):
        x2p, n2, P2 = _flat_patches(x2)
        v = torch.func.vmap(lambda x2b: cross_var(f2, self.g, x, x2b))(
            x2p.reshape(n2, P2, -1).transpose(0, 1))
        return v.sum(dim=0)


def patch_convolve(g: AbstractProcess, chunk=None) -> PatchConvolveGP:
    return PatchConvolveGP(g, n=g.gpc.next_index(), gpc=g.gpc, chunk=chunk)


@gppp
def build_gp(t, chunk=None):
    g = GP(t["var"] * with_lengthscale(SEKernel(), t["l"]))
    return dict(g=g, f=patch_convolve(g, chunk))


def smooth_images(rng, n, h):
    """`n` smooth random h × h images: doubly cumulated normal noise / h."""
    base = rng.normal(size=(n, h, h))
    return np.cumsum(np.cumsum(base, axis=1), axis=2) / h


def k01_brute_force(g, pp):
    """K[0, 1] of the image process as the sum of g's covariance over every
    patch pair of images 0 and 1, one 1 × 1 kernel matrix at a time."""
    return sum(g.cov2(pp[0, i:i + 1], pp[1, j:j + 1])[0, 0].item()
               for i in range(pp.shape[1]) for j in range(pp.shape[1]))


def main(device="cuda", fast=False):
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(0)
    N, H = 12, 8
    imgs = tensor(smooth_images(rng, N, H), dev)
    f = build_gp(dict(var=1.0, l=1.0))
    x = GPPPInput("f", imgs)

    # the statistics exist and agree (script.jl:85-95)
    m, K, v = f.mean(x), f.cov(x), f.var(x)
    check(tuple(m.shape) == (N,) and tuple(K.shape) == (N, N) and tuple(v.shape) == (N,),
          f"shapes {tuple(m.shape)}, {tuple(K.shape)}, {tuple(v.shape)}")
    out = {"asymmetry": (K - K.T).abs().max().item(),
           "var_vs_diag": (v - torch.diagonal(K)).abs().max().item()}
    check(out["asymmetry"] <= 1e-9, f"K is not symmetric: {out['asymmetry']}")
    check(torch.allclose(v, torch.diagonal(K), rtol=1e-9, atol=1e-9),
          f"var differs from diag(K): {out['var_vs_diag']}")

    # the brute-force oracle for one entry
    k01 = k01_brute_force(f["g"], extract_patches(imgs))
    out["k01_rel_err"] = abs(K[0, 1].item() - k01) / abs(k01)
    check(out["k01_rel_err"] <= 1e-8, f"K[0, 1] against the patch-pair sum: {out['k01_rel_err']}")

    # the interdomain cross-covariance, image process × patch process
    # (script.jl:102), and VFE with inducing points in patch space
    M = 32
    z = GPPPInput("g", tensor(rng.normal(size=(M, PATCH * PATCH)), dev))
    Kfz = f.cov2(x, z)
    check(tuple(Kfz.shape) == (N, M), f"Kfz shape {tuple(Kfz.shape)}")
    y = rand(gen, f(x, 0.1))
    out["logpdf"] = logpdf(f(x, 0.1), y).item()
    out["elbo"] = elbo(VFE(f(z, 1e-6)), f(x, 0.1), y).item()
    print(f"exact logpdf {out['logpdf']:.3f}; patch-domain VFE elbo {out['elbo']:.3f}")
    check(out["elbo"] <= out["logpdf"] + 1e-6, f"the ELBO exceeds the logpdf: {out}")

    # inducing points at the data's patches tighten the bound
    z_data = GPPPInput("g", extract_patches(imgs).reshape(-1, PATCH * PATCH)[:4 * M])
    out["elbo_data_patches"] = elbo(VFE(f(z_data, 1e-6)), f(x, 0.1), y).item()
    print(f"elbo with data-patch inducing points: {out['elbo_data_patches']:.3f}")
    check(out["elbo_data_patches"] >= out["elbo"] - 1e-6,
          f"data-patch inducing points loosened the bound: {out}")
    print("convolutional_gp: OK")
    return out


# --- the full-width run -------------------------------------------------------


def full_data(n_images=4096, h=28, m=512, dtype=torch.float32, device="cuda"):
    """`(imgs, z, y)`: `n_images` smooth h × h images, `m` inducing points
    in patch space (standard normal) and targets y = tanh of each image's
    mean intensity plus noise of variance 0.01, all numpy from seed 0."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    imgs = smooth_images(rng, n_images, h)
    z = rng.normal(size=(m, PATCH * PATCH))
    y = np.tanh(imgs.mean(axis=(1, 2))) + 0.1 * rng.normal(size=n_images)
    return tuple(tensor(a, dev, dtype) for a in (imgs, z, y))


def neg_elbo(theta, imgs, z, y, chunk=None):
    """−ELBO of y at the images under `build_gp(theta)` and the example's
    noise 0.1, inducing points z in patch space (jitter 1e-6)."""
    f = build_gp(theta, chunk)
    return -elbo(VFE(f(GPPPInput("g", z), 1e-6)), f(GPPPInput("f", imgs), 0.1), y)


if __name__ == "__main__":
    run_cli(main, __doc__)

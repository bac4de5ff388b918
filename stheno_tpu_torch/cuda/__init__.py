"""Hand-written CUDA kernels for Hopper (`sm_90a`), one for each Pallas
kernel of the JAX package, each with its plain PyTorch version beside it:

- `kernelmatrix`: the pairwise stationary kernel matrix (kernel 1), its
  batched launch (a grid dimension over a `torch.func.vmap` batch), and its
  reverse rule (the VJP kernel);
- `chol_block.chol_block`: base-case Cholesky of a batch of blocks (kernel 2);
- `chol_block.tri_inv_block`: base-case triangular inverse (kernel 3);
- `kernelmatrix.km_se_d1`: the performance probe's same-input SE matrix of a
  vector (kernel 4), launched on kernel 1's SE, D = 1 instance;
- `tf32_split.tf32_split`: the TF32 split of an f32 operand for the 3xTF32
  products of the 'high' GEMM precision (no Pallas kernel: on the TPU, XLA
  splits a HIGH dot's operands itself).

Sources are in `csrc/`, built by `_build` at first use.  Nothing here
compiles or loads a kernel at import.
"""

from stheno_tpu_torch.cuda import chol_block, kernelmatrix, tf32_split
from stheno_tpu_torch.cuda._build import build

#: Every kernel's launch counter, by kernel name.
COUNTERS = {
    "kernelmatrix": kernelmatrix.LAUNCHES,
    "kernelmatrix_batched": kernelmatrix.BATCHED_LAUNCHES,
    "kernelmatrix_vjp": kernelmatrix.VJP_LAUNCHES,
    "chol_block": chol_block.CHOL_LAUNCHES,
    "tri_inv_block": chol_block.TRI_INV_LAUNCHES,
    "km_se_d1": kernelmatrix.KM_SE_D1_LAUNCHES,
    "tf32_split": tf32_split.SPLIT_LAUNCHES,
}


def reset_counters() -> None:
    for counter in COUNTERS.values():
        counter.reset()


def build_all():
    """Build every kernel library (one nvcc per source, in parallel)."""
    return build("kernelmatrix", "chol_block", "tf32_split")

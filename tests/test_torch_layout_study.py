"""The layout study (`stheno_tpu_torch.layout_study`) at P = 4 (a 2 × 2
grid), N = 256, B = 32 over gloo on the CPU, started through its own
`main`: the masked 2-D prototype's factor in f64 against
`np.linalg.cholesky` and against the JAX package's
`distributed_cholesky_cyclic` factor; the counted per-rank multiply-adds of
the cyclic and 2-D factors within 15 % of N³/(3P) on the busiest rank, the
slab's within 15 % of N³/(2P)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from stheno_tpu.parallel.cholesky import distributed_cholesky_cyclic
from stheno_tpu_torch import layout_study
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

P, N, B = 4, 256, 32
ARGS = ["--p", str(P), "--n", str(N), "--block", str(B), "--device", "cpu"]


def test_grid_is_near_square():
    assert [layout_study.grid(p) for p in (1, 2, 4, 6, 8, 16, 32)] == [
        (1, 1), (1, 2), (2, 2), (2, 3), (2, 4), (4, 4), (4, 8)]


def test_the_2d_prototype_factor_in_f64():
    out = layout_study.main(ARGS + ["--check", "--dtype", "float64"])
    assert out["check"] == "ok" and out["grid"] == [2, 2]
    K = layout_study.spd_matrix(N)
    L_ref = np.linalg.cholesky(K)
    L = out["factor"]
    assert np.abs(L - L_ref).max() / np.abs(L_ref).max() < 1e-10
    assert out["rel_err"] < 1e-10
    mesh = Mesh(np.asarray(jax.devices()[:P]), ("rows",))
    with mesh:
        L_jax = np.asarray(jax.jit(lambda k: distributed_cholesky_cyclic(mesh, k, block_size=B))(
            jnp.asarray(K)))
    np.testing.assert_allclose(L, L_jax, rtol=0, atol=1e-10 * np.abs(L_jax).max())


def test_counted_flops_per_rank_against_the_floors():
    out = layout_study.main(ARGS)
    assert out["grid"] == [2, 2] and len(out["cyclic_flops_per_rank"]) == P
    for name, floor in (("cyclic", N**3 / (3 * P)), ("masked2d", N**3 / (3 * P)),
                        ("slab", N**3 / (2 * P))):
        busiest = max(out[f"{name}_flops_per_rank"]) / 2  # two FLOPs a multiply-add
        assert busiest == out[f"{name}_macs"]
        assert abs(busiest / floor - 1) <= 0.15, (name, busiest, floor)
    assert out["floor_2d_triangle_unreachable"] == N**3 / (6 * P)
    assert out["comm_words_2d"] == N * N / 2 + N * N / 2


def test_the_study_refuses_a_grid_the_blocks_do_not_divide():
    with pytest.raises(ValueError, match="block count"):
        layout_study.main(["--p", "1", "--n", "250", "--block", "32", "--device", "cpu"])

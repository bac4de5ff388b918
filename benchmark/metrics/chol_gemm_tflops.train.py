"""`chol_gemm_tflops.train`: the logical GEMM work (`gemm_flops`, 2·m·n·k
of each product, at any precision) a fit step in the program's
`chol.factor` and `chol.reverse` spans over their device time a step, in
TFLOP/s, each by the per-unit rule of `harness/program_spans.py`."""

from harness.program_spans import gemm_tflops
from harness.readings import FIT


def read(run):
    return gemm_tflops(run, FIT, ("chol.factor", "chol.reverse"))

"""`gemm_ms_per_step`: device milliseconds of GEMM kernels a step, in the
traced window."""

from harness.readings import FIT, kind_seconds, traced_per_unit


def read(run):
    if run["kind"] not in FIT:
        return None
    t = traced_per_unit(run, kind_seconds(run, "gemm"))
    return None if t is None else t * 1e3

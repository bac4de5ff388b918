"""`solve_ms_per_request`: device milliseconds of GEMM and TRSM kernels a
request, in the traced window."""

from harness.readings import REQUESTS, kind_seconds, traced_per_unit


def read(run):
    if run["kind"] not in REQUESTS:
        return None
    t = traced_per_unit(run, kind_seconds(run, "gemm", "trsm"))
    return None if t is None else t * 1e3

"""`cov_ms.request`: device milliseconds a request in the program's `cov`
spans (covariance blocks asked of the process graph, down to kernel 1), by
the per-unit rule of `harness/program_spans.py`."""

from harness.program_spans import device_ms
from harness.readings import REQUESTS


def read(run):
    return device_ms(run, REQUESTS, ("cov",))

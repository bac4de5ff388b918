"""`cov_ms.train`: device milliseconds a fit step in the program's `cov`
and `cov.reverse` spans (covariance blocks asked of the process graph, down
to kernel 1, and kernel 1's reverse rule), by the per-unit rule of
`harness/program_spans.py`."""

from harness.program_spans import device_ms
from harness.readings import FIT


def read(run):
    return device_ms(run, FIT, ("cov", "cov.reverse"))

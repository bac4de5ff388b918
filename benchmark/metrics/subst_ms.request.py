"""`subst_ms.request`: device milliseconds a request in the program's
`solve` spans (the triangular substitutions), by the per-unit rule of
`harness/program_spans.py`."""

from harness.program_spans import device_ms
from harness.readings import REQUESTS


def read(run):
    return device_ms(run, REQUESTS, ("solve",))

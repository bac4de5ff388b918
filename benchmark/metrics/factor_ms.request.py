"""`factor_ms.request`: device milliseconds a request in the program's
`chol.factor` spans, by the per-unit rule of `harness/program_spans.py`."""

from harness.program_spans import device_ms
from harness.readings import REQUESTS


def read(run):
    return device_ms(run, REQUESTS, ("chol.factor",))

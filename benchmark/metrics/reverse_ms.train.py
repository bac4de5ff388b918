"""`reverse_ms.train`: device milliseconds a fit step in the program's
`chol.reverse` spans (the factor's reverse rule), by the per-unit rule of
`harness/program_spans.py`."""

from harness.program_spans import device_ms
from harness.readings import FIT


def read(run):
    return device_ms(run, FIT, ("chol.reverse",))

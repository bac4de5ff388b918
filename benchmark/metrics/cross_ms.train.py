"""`cross_ms.train`: device milliseconds a fit step in the program's
`cov.cross` spans (the dense blocks of processes stacked over `BlockData`
and their concatenation, inside the `cov` span), by the per-unit rule of
`harness/program_spans.py`.  A program without that span reads None."""

from harness.program_spans import device_ms
from harness.readings import FIT


def read(run):
    return device_ms(run, FIT, ("cov.cross",))

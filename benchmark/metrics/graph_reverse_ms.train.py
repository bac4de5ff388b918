"""`graph_reverse_ms.train`: device milliseconds a fit step in the program's
`graph.reverse` spans (the reverse of the process graph's algebra behind the
step's covariance, from its cotangent to the end of the backward pass,
kernel 1's reverse rule inside it), by the per-unit rule of
`harness/program_spans.py`.  A program without that span reads None."""

from harness.program_spans import device_ms
from harness.readings import FIT


def read(run):
    return device_ms(run, FIT, ("graph.reverse",))

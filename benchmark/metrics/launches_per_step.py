"""`launches_per_step`: device kernels in the traced window over its steps."""

from harness.readings import FIT, launches


def read(run):
    return launches(run, FIT)

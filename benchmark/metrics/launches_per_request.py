"""`launches_per_request`: device kernels in the traced window over its
requests."""

from harness.readings import REQUESTS, launches


def read(run):
    return launches(run, REQUESTS)

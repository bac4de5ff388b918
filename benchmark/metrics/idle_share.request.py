"""`idle_share.request`: the share (%) of the traced window in which no
operation ran on the device, over requests."""

from harness.readings import REQUESTS, idle_share


def read(run):
    return idle_share(run, REQUESTS)

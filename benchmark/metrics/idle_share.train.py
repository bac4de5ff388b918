"""`idle_share.train`: the share (%) of the traced window in which no
operation ran on the device, over fit steps."""

from harness.readings import FIT, idle_share


def read(run):
    return idle_share(run, FIT)

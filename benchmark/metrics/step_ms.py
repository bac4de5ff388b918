"""`step_ms`: the window's milliseconds over the fit steps it completed."""

from harness.readings import FIT, unit_s


def read(run):
    t = unit_s(run) if run["kind"] in FIT else None
    return None if t is None else t * 1e3

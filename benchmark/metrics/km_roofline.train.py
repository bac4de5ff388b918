"""`km_roofline.train`: kernel 1's forward launches in a fit step, their
least time (`roofline.km_forward_least_s` of each launch the port counted)
over their device time (%)."""

from harness.readings import FIT, km_roofline


def read(run):
    return km_roofline(run, FIT, "forward", "kernelmatrix")

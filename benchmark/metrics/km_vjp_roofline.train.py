"""`km_vjp_roofline.train`: kernel 1's VJP launches in a fit step, their
least time (`roofline.km_vjp_least_s`) over their device time (%)."""

from harness.readings import FIT, km_roofline


def read(run):
    return km_roofline(run, FIT, "vjp", "kernelmatrix_vjp")

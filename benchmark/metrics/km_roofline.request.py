"""`km_roofline.request`: kernel 1's launches in a request, their least
time (`roofline.km_forward_least_s`) over their device time (%)."""

from harness.readings import REQUESTS, km_roofline


def read(run):
    return km_roofline(run, REQUESTS, "forward", "kernelmatrix")

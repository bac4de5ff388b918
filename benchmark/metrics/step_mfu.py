"""`step_mfu`: the problem's float32 work a step (`counts/`) over the step
time of the untraced window, as a share (%) of the H100's float32 peak."""

from harness.readings import FIT, mfu


def read(run):
    return mfu(run, FIT)

"""`request_mfu`: the problem's float32 work a request (`counts/`) over the
mean request time of the untraced window, as a share (%) of the float32 peak."""

from harness.readings import REQUESTS, mfu


def read(run):
    return mfu(run, REQUESTS)

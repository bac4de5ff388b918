"""`host_ms.request`: host milliseconds a request inside the program's
outermost spans (the union of a call's host intervals), by the per-unit
rule of `harness/program_spans.py`."""

from harness.program_spans import host_ms
from harness.readings import REQUESTS


def read(run):
    return host_ms(run, REQUESTS)

"""`points_per_s`: query points answered over the window's seconds."""

from harness.readings import REQUESTS


def read(run):
    w = run["window"]
    if run["kind"] not in REQUESTS or not w["units"]:
        return None
    return w["units"] * w["points_per_unit"] / w["window_s"]

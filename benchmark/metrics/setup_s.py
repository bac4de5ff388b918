"""`setup_s`: seconds from the process's start to the first timed unit."""


def read(run):
    return run["setup_s"]

"""Set-up: process start to the window's first timed request or call."""


def read(run):
    return run.setup_s

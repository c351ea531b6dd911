"""Process start to the window's start: imports, the kernels' build (the
first run in a checkout only), weights, warm-up, and the traffic's ramp."""


def read(run):
    return run.setup_s

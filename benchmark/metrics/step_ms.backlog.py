"""The window over the decode steps dispatched in it (blocks · block)."""


def read(run):
    steps = run.blocks * run.mix["block"]
    return 1000.0 * (run.window[1] - run.window[0]) / steps if steps else None

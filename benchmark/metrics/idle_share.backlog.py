"""Share of the traced span in which no operation ran on the card."""


def read(run):
    t = run.trace
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])

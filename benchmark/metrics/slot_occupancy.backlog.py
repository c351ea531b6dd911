"""Live slots over the slot count, sampled at a fixed period over the
window."""


def read(run):
    if not run.occupancy:
        return None
    return 100.0 * sum(run.occupancy) / len(run.occupancy) / run.mix["slots"]

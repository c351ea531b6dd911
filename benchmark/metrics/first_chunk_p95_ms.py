"""95th percentile, over every request due in the window, of the time from
when it was due to its first chunk (host clock); a failed or unfinished
request counts as missing."""

from harness.e2e import first_chunk_s, judged, p95


def read(run):
    return 1000.0 * p95([first_chunk_s(r) for r in judged(run)])

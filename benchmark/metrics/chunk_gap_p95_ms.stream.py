"""95th percentile of the benchmark's clock between consecutive chunks of
each stream, over every gap that ends in the window."""

from harness.e2e import p95


def read(run):
    w0, w1 = run.window
    gaps = [b[0] - a[0] for r in run.records for a, b in
            zip(r.get("chunks", []), r.get("chunks", [])[1:])
            if w0 <= b[0] < w1]
    return 1000.0 * p95(gaps) if gaps else None

"""95th percentile, over every request due in the window, of (final chunk
time − first chunk time) / seconds of audio after the first chunk: above 1
a listener who starts at the first chunk hears a stall."""

from harness.e2e import judged, p95, stream_rtf


def read(run):
    return p95([stream_rtf(r) for r in judged(run)])

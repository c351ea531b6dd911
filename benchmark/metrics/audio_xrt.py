"""Seconds of audio returned by requests that completed in the window,
over the window's seconds (host clock)."""

from harness.e2e import judged


def read(run):
    w0, w1 = run.window
    return sum(r["audio_s"] for r in judged(run) if not r["failed"]) / (w1 - w0)

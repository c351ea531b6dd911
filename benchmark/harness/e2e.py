"""Arithmetic the end-to-end metrics share (``metrics/<name>.py`` read
them): each is taken over all the work and all the time of the window. A
request that failed, or that lacks a first or final chunk once the drain
ends, misses every latency limit: it enters a tail as +inf."""

from __future__ import annotations

import math
from typing import List

INF = float("inf")


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank (a tail that +inf can enter)."""
    if not values:
        return INF
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def judged(run) -> List[dict]:
    """The requests the window is judged by: closed loop, those that ended
    inside it; open loop, those due inside it."""
    w0, w1 = run.window
    if run.mix["loop"] == "open":
        return [r for r in run.records if w0 <= r["due"] < w1]
    return [r for r in run.records if w0 <= r.get("t_done", -1) < w1]


def finite(x: float) -> float:
    """A tail that a missing request made infinite, or a number with
    nothing to compare, is reported as 1e9 of its unit (JSON has no
    infinity)."""
    return 1e9 if x == INF else x


def first_chunk_s(r) -> float:
    """Due time to the first chunk; +inf for a request that failed or did
    not finish."""
    if r["failed"] or not r.get("chunks") or "t_done" not in r:
        return INF
    return r["chunks"][0][0] - r["due"]


def stream_rtf(r) -> float:
    """(final chunk − first chunk) / seconds of audio after the first
    chunk; above 1 a listener who starts at the first chunk hears a
    stall."""
    if first_chunk_s(r) == INF:
        return INF
    after = sum(n for _, n in r["chunks"][1:]) / 16000.0
    if after <= 0.0:
        return 0.0
    return (r["chunks"][-1][0] - r["chunks"][0][0]) / after

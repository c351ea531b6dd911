"""The serving path's span recorder, on the device trace's clock.

One recorder for the process, off by default. Code at the boundaries of the
serving path's layers tests ``trace.on`` (one attribute test, no
allocation) and, while it is on, appends what happened:

  * a span ``(id, name, t0, t1, req, cause, n, cpu)``: ``t0``, ``t1`` in
    nanoseconds of ``now()``; ``req`` the request's trace id (the one
    ``ContinuousEngine.submit`` returns) or 0; ``cause`` the id of the
    span that caused it (the admission burst a request entered, the window
    a turn was waited for in) or 0; ``n`` a size (a burst, a bucket, the
    latents, the slots moved, the tokens routed) or a readback's block
    number; ``cpu`` the thread's CPU nanoseconds over the span
    (``time.thread_time_ns()``), or -1 where not taken;
  * a mark ``(name, t, req, cause, n)``, an instant.

Spans and marks are tuples appended to lists, in memory; nothing is
written while serving. ``export()`` hands them over, ``reset()`` drops
them. ``enable``, ``disable``, ``reset`` and ``export`` are the interface
for whoever reads them; the rest is for the code that records.

The clock is ``now()``, the monotonic clock (``time.monotonic_ns()``):
one read a boundary, which the ``stats``, histograms and turn waits that
the program keeps also take their durations from, so none of them can go
negative when the wall clock is stepped. ``export()`` moves every stamp
onto the host's wall clock (``time.time_ns()``), on which Kineto stamps the
card's operations, by the offset between the two clocks taken at
``enable()``: a span lines up with the device trace.

A caller hands its request to the code below it through a thread-local
binding (``request``, ``scope``): ``stream_synthesize`` binds the id that
``submit`` returned, the streaming vocoder's windows and
``TtsPipeline.vocode`` bind their span as the parent of the vocoder's turn
(``GraphCache.exclusive``) and of its read-back (``child``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional, Tuple

on = False

now = time.monotonic_ns

_spans: list = []
_marks: list = []
_ids = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    id: int
    name: str
    t0: int
    t1: int
    req: int
    cause: int
    n: int
    cpu: int


class Mark(NamedTuple):
    name: str
    t: int
    req: int
    cause: int
    n: int


def _wall_offset() -> int:
    return time.time_ns() - now()


_offset = _wall_offset()


def enable() -> None:
    """Starts recording; takes the wall clock's offset from ``now()``."""
    global on, _offset
    _offset = _wall_offset()
    on = True


def disable() -> None:
    global on
    on = False


def reset() -> None:
    """Drops what was recorded."""
    _spans.clear()
    _marks.clear()


def export() -> dict:
    """What was recorded so far: ``{"spans": [Span], "marks": [Mark]}``,
    each list in the order of recording, its stamps in nanoseconds of the
    wall clock (``time.time_ns()``)."""
    # each copy is one step under the interpreter's lock, as each append is
    off, spans, marks = _offset, list(_spans), list(_marks)
    return {"spans": [Span(i, k, t0 + off, t1 + off, r, c, n, u)
                      for i, k, t0, t1, r, c, n, u in spans],
            "marks": [Mark(k, t + off, r, c, n) for k, t, r, c, n in marks]}


def new_id() -> int:
    """A fresh id: a request's (``ContinuousEngine.submit``), or a span's
    whose children are recorded before it ends."""
    return next(_ids)


def span(name: str, t0: int, t1: int, req: int = 0, cause: int = 0,
         n: int = 0, cpu: int = -1, sid: int = 0) -> int:
    """Records a span; returns its id (``sid`` where given)."""
    sid = sid or next(_ids)
    _spans.append((sid, name, t0, t1, req, cause, n, cpu))
    return sid


def mark(name: str, t: int, req: int = 0, cause: int = 0, n: int = 0):
    _marks.append((name, t, req, cause, n))


def bound() -> Tuple[int, int]:
    """This thread's (request, parent span), (0, 0) where none is bound."""
    return getattr(_local, "req", 0), getattr(_local, "parent", 0)


@contextlib.contextmanager
def request(req: int):
    """Inside, this thread works for request ``req`` (no parent span)."""
    prev = bound()
    _local.req, _local.parent = req, 0
    try:
        yield
    finally:
        _local.req, _local.parent = prev


@contextlib.contextmanager
def scope(name: str, req: Optional[int] = None, n: int = 0):
    """The span ``name`` around the block, for request ``req`` (None: the
    one this thread has bound), bound meanwhile as the parent of what the
    thread records inside (``child``, ``GraphCache.exclusive``)."""
    prev = bound()
    req = prev[0] if req is None else req
    sid = next(_ids)
    t0 = now()
    _local.req, _local.parent = req, sid
    try:
        yield sid
    finally:
        _local.req, _local.parent = prev
        span(name, t0, now(), req=req, n=n, sid=sid)


def child(name: str, t0: int, n: int = 0) -> None:
    """The span ``name`` from ``t0`` to now, under this thread's bound
    request and parent."""
    req, parent = bound()
    span(name, t0, now(), req=req, cause=parent, n=n)


# what ``with trace.scope(...) if trace.on else trace.OFF:`` enters while
# the recorder is off: one object for every such block, no allocation
OFF = contextlib.nullcontext()

"""The device trace of a traced run: CUPTI's record of every operation on
the card over a few seconds after the window, through
``torch.profiler``'s Kineto back end at its lowest level (its events are
read as they come, without building the profiler's event tree, which costs
about half a millisecond a kernel). Kineto stamps device events on the
host's wall clock, so they line up with the benchmark's own spans.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Kernel = Tuple[str, float, float]        # (name, start s, duration s)


class DeviceTrace:
    def __init__(self):
        from torch.autograd import ProfilerActivity, ProfilerConfig, \
            ProfilerState
        self._acts = {ProfilerActivity.CUDA}
        self._cfg = ProfilerConfig(
            ProfilerState.KINETO, False, False, False, False, False,
            torch._C._profiler._ExperimentalConfig())

    def start(self):
        from torch.autograd import _enable_profiler, _prepare_profiler
        _prepare_profiler(self._cfg, self._acts)
        _enable_profiler(self._cfg, self._acts)

    def stop(self):
        """Ends the trace; returns its raw result for ``kernels``."""
        from torch.autograd import _disable_profiler
        return _disable_profiler()


def kernels(result) -> List[Kernel]:
    """The device operations of a stopped trace, by start. Reading them
    holds the interpreter for seconds at 128 slots: the run does it once
    its window has closed."""
    out = []
    for e in _device_events(result):
        out.append((e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9))
    out.sort(key=lambda k: k[1])
    return out


def busy_intervals(kernels: List[Kernel], t0: float, t1: float):
    """The union of the operations' intervals, clipped to [t0, t1]."""
    out: List[List[float]] = []
    for _, s, d in kernels:
        a, b = max(s, t0), min(s + d, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summary(kernels: List[Kernel], t0: float, t1: float,
            spans: List[tuple]) -> Dict[str, object]:
    """busy seconds, the window, the ten costliest operations by name and
    the ten longest idle gaps, each named by what the host was doing: the
    decode loop's span (admission, dispatch, readback) that covers most of
    the gap, else "vocode" where a request was being vocoded, else
    "other"."""
    iv = busy_intervals(kernels, t0, t1)
    busy = sum(b - a for a, b in iv)
    by_name: Dict[str, float] = {}
    for name, s, d in kernels:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, prev = [], t0
    for a, b in iv + [[t1, t1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    return {"busy_s": busy, "window_s": t1 - t0,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[_gap_name(a, b, spans), b - a]
                          for a, b in gaps[:10]]}


def _gap_name(a: float, b: float, spans: List[tuple]) -> str:
    cover: Dict[str, float] = {}
    vocode = False
    for kind, s0, s1, _ in spans:
        o = min(b, s1) - max(a, s0)
        if o <= 0:
            continue
        if kind == "vocode":
            vocode = True
        else:
            cover[kind] = cover.get(kind, 0.0) + o
    if cover:
        return max(cover, key=cover.get)
    return "vocode" if vocode else "other"


def capture(trace_s: float, quiet, tries: int = 3):
    """Trace ``trace_s`` seconds of the system under its traffic: (raw
    result, t0, t1), the span [t0, t1] starting once the system resumed.
    The profiler starts and stops inside ``quiet()`` (no other thread
    launching work then). It now and then returns no device event for a
    window, so up to ``tries`` windows are taken."""
    import time
    from .traffic import now
    for _ in range(tries):
        tr = DeviceTrace()
        with quiet():
            tr.start()
        t0 = now() + 0.25          # the loop's first block after resuming
        time.sleep(0.25 + trace_s)
        t1 = now()
        with quiet():
            res = tr.stop()
        if any(True for _ in _device_events(res)):
            return res, t0, t1
    return None


def _device_events(result):
    from torch.autograd import DeviceType
    return (e for e in result.events() if e.device_type() == DeviceType.CUDA)

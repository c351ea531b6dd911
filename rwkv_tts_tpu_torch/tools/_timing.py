"""Timing shared by the attribution tools.

On a card every piece gets two numbers from ``utils/timing.py``, the
yardstick ``chip_smoke.py`` uses too: ``wall_ms``, CUDA events around a
loop of calls (the time the card took, idle gaps while the host prepares
the next launch included), and ``device_ms``, the summed duration of the
CUDA kernels those calls ran (``torch.profiler``). In eager PyTorch the
difference is host time. On the CPU ``wall_ms`` is the host clock and
``device_ms`` is None: no device was measured.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ..ops import conv1d as C1
from ..ops import quant as Q
from ..ops import wkv7 as W
from ..utils.timing import device_ms, device_ms_by_kernel, event_ms


def timed(fn: Callable[[], object], iters: int, device: torch.device,
          per: int = 1) -> Dict[str, Optional[float]]:
    """ms of ``fn`` per call divided by ``per`` (the steps or layers one
    call runs), after one warmup call: ``wall`` and, on a card, the device
    time of ``iters`` more calls."""
    out = {"wall_ms": wall(fn, iters, device, per), "device_ms": None}
    if device.type == "cuda":
        dev = device_ms(fn, iters, warmup=0)
        out["device_ms"] = None if dev is None else dev / per
    return out


def wall(fn: Callable[[], object], iters: int, device: torch.device,
         per: int = 1, warmup: int = 1) -> float:
    """Wall ms of ``fn`` per call divided by ``per``, after ``warmup``
    calls: CUDA events around ``iters`` calls on a card (its idle gaps
    included), the host clock on the CPU. No profiler runs."""
    if device.type != "cuda":
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters / per
    return event_ms(fn, iters, warmup=warmup) / per


def busy(fn: Callable[[], object], device: torch.device, per: int = 1,
         iters: int = 1, top: int = 0, expect: int = 1) -> Dict:
    """Device busy ms and kernels of a call of ``fn`` divided by ``per``,
    over ``iters`` calls after one warmup call (``torch.profiler``; a
    window in which the profiler saw fewer than ``expect`` kernels a call
    is measured again, up to 3 times, and then read as None); with
    ``top``, also the ``top`` kernels by device time, each [name (cut to
    80 characters), ms, launches], per call over ``per``. The readings
    are None on the CPU. The profiler spends ~0.5 ms of host time a
    kernel, so profile a few steps, not a stage; a call of a kernel or two
    alone is better profiled over several calls."""
    out: Dict = {"device_ms": None, "kernels": None}
    if top:
        out["top"] = None
    if device.type != "cuda":
        return out
    for warm in (1, 0, 0):
        counts: Dict[str, float] = {}
        by = device_ms_by_kernel(fn, iters, warmup=warm, counts=counts)
        if by and sum(counts.values()) >= expect - 1e-6:
            out["device_ms"] = sum(by.values()) / per
            out["kernels"] = sum(counts.values()) / per
            if top:
                out["top"] = [[k[:80], v / per, counts[k] / per]
                              for k, v in sorted(by.items(),
                                                 key=lambda kv: -kv[1])[:top]]
            return out
    return out


def minus(a: Dict[str, Optional[float]], b: Dict[str, Optional[float]]
          ) -> Dict[str, Optional[float]]:
    """a − b per key, None where either side is None."""
    return {k: None if a[k] is None or b[k] is None else a[k] - b[k]
            for k in a}


def card_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _counts() -> Dict[str, int]:
    return {**W.LAUNCHES, **Q.LAUNCHES, **C1.LAUNCHES}


class Launches:
    """Every kernel wrapper's launches while a tool runs (the counters are
    the process's; this takes the difference)."""

    def __init__(self):
        self.before = _counts()

    def delta(self) -> Dict[str, int]:
        return {k: v - self.before.get(k, 0) for k, v in _counts().items()}

"""Prometheus-format histogram (text exposition only).

Own copy of the host-only ``Histogram``, ``LATENCY_BUCKETS``,
``RTF_BUCKETS`` and ``STAGE_BUCKETS`` of ``rwkv_tts_tpu/utils/metrics.py``:
the continuous engine records each request's ``queue_wait`` and
``first_emit``, the server each request's latency, RTF and first chunk.
Dependency-free; the server's connection threads observe concurrently, so
``observe`` and ``render`` hold a lock."""

from __future__ import annotations

import math
import threading
from typing import List, Sequence

# request latencies: 50 ms … 60 s
LATENCY_BUCKETS = (0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 1.0, 1.5, 2.5, 5.0,
                   10.0, 20.0, 40.0, 60.0)
# RTF: 0.002 (500× realtime) … 1.0
RTF_BUCKETS = (0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 1.0)
# per-request serving stages (queue wait / first emit / first chunk): the
# interesting regime is tens of ms, so the low end is fine-grained
STAGE_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.15, 0.25, 0.4, 0.6, 1.0, 1.5,
                 2.5, 4.0, 6.0, 10.0, 20.0)


class Histogram:
    """Cumulative-bucket histogram in the Prometheus exposition format."""

    def __init__(self, name: str, buckets: Sequence[float],
                 help_text: str = ""):
        self.name = name
        self.help = help_text
        self.bounds = tuple(sorted(buckets))
        self.counts = [0] * (len(self.bounds) + 1)   # + the +Inf bucket
        self.total = 0.0
        self.n = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        if value != value or value in (math.inf, -math.inf):
            return
        with self._lock:
            for i, b in enumerate(self.bounds):
                if value <= b:
                    self.counts[i] += 1
                    break
            else:
                self.counts[len(self.bounds)] += 1
            self.total += value
            self.n += 1

    def render(self) -> List[str]:
        with self._lock:
            return self._render()

    def _render(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} histogram")
        cum = 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            lines.append(f'{self.name}_bucket{{le="{b:g}"}} {cum}')
        cum += self.counts[-1]
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{self.name}_sum {self.total}")
        lines.append(f"{self.name}_count {self.n}")
        return lines

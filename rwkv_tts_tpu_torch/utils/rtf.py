"""Per-stage stopwatch and RTF; the port's own copy of ``StageTimer`` and
``calculate_rtf`` from ``rwkv_tts_tpu/utils/rtf.py`` (reference:
bin/server.rs:151-159, 451-693)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict


class StageTimer:
    def __init__(self):
        self._stages: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self._stages[name] = self._stages.get(name, 0.0) + (
                time.perf_counter() - t
            )

    def total_seconds(self) -> float:
        return time.perf_counter() - self._t0

    def as_ms(self) -> Dict[str, float]:
        out = {k: round(v * 1000.0, 2) for k, v in self._stages.items()}
        out["total"] = round(self.total_seconds() * 1000.0, 2)
        return out


def calculate_rtf(audio_samples: int, processing_seconds: float,
                  sample_rate: int = 16000) -> float:
    """processing time / audio duration (bin/server.rs:151-159)."""
    dur = audio_samples / sample_rate
    return processing_seconds / dur if dur > 0 else 0.0

"""Device timing on a card: the one yardstick of the attribution tools
(``rwkv_tts_tpu_torch/tools``) and of ``chip_smoke.py``.

``event_ms`` is the card's time per call by CUDA events around a loop, the
idle gaps while the host prepares the next launch included; ``device_ms``
is the summed duration of the CUDA kernels the calls ran, from
``torch.profiler`` (CUPTI). In eager PyTorch the difference is host time.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def event_ms(fn: Callable[[], object], iters: int, warmup: int = 1) -> float:
    """Mean ms per call of ``fn`` by CUDA events around ``iters`` calls,
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn: Callable[[], object], iters: int,
              warmup: int = 1) -> Optional[float]:
    """Device time per call of ``fn`` in ms: the summed self time of the
    CUDA kernels that ``iters`` calls ran, after ``warmup`` calls. None when
    the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return us / iters / 1e3 if us > 0 else None


def device_ms_by_kernel(fn: Callable[[], object], iters: int,
                        warmup: int = 1,
                        counts: Optional[Dict[str, float]] = None
                        ) -> Dict[str, float]:
    """``device_ms`` split by kernel name: device ms per call of ``fn`` of
    each CUDA kernel it ran (the profiler's full names); ``counts``, where
    given, receives each kernel's launches per call as the profiler saw
    them."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", 0.0)
            out[e.key] = out.get(e.key, 0.0) + us / iters / 1e3
            if counts is not None:
                counts[e.key] = counts.get(e.key, 0.0) + e.count / iters
    return out

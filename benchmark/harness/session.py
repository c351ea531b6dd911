"""One run of one cell: set-up, the window, the metrics, the check."""

from __future__ import annotations

import gc
import sys
import threading
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, trace, traffic, weights
from .cell import Cell
from .e2e import finite, judged

FORBIDDEN = ("jax", "jaxlib", "flax", "rwkv_tts_tpu")


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name (before the first dot), taken
    whole, is JAX's, Flax's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def log(msg: str):
    """A progress line on standard error, with the host clock."""
    print(f"[{traffic.now():.3f}] {msg}", file=sys.stderr, flush=True)


def _sleep_until(t: float):
    while True:
        left = t - traffic.now()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def _drain(records: List[dict], w0: float, w1: float, until: float):
    """Waits, at most until ``until``, for every request due in [w0, w1)
    to end."""
    while traffic.now() < until and any(
            w0 <= r["due"] < w1 and "t_done" not in r and not r["failed"]
            for r in list(records)):
        time.sleep(0.1)


def _vocode_latents(mix: dict) -> List[int]:
    """One length in each detokenize bucket a backlog request can reach:
    the caps' range, and below it any length an early EOS leaves."""
    hi = int(np.ceil(mix["tokens_per_word"] * mix["words"][1]
                     * mix["cap_jitter"][1]))
    out, S = [], 1
    for bucket in (128, 256, 512, 1024, 2048):
        if S > hi:
            break
        out.append(S)
        S = bucket - 85 + 1
    return out


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: bool = False) -> Dict[str, object]:
    """Runs the cell once; returns the result's fields (``checks`` last).
    ``control`` runs the program at the configuration's control
    precisions instead (``check``)."""
    from .system import System

    dev = torch.device(device)
    cfg, mix = cell.config, cell.mix
    lm_raw = weights.lm_tree(cfg["lm"], seed, dev)
    codec = weights.codec_tree(cfg["codec"], seed, dev)
    system = System(cfg, mix, lm_raw, codec, dev,
                    cfg["control"] if control else None)
    del lm_raw
    reqs = traffic.requests(mix, seed, traffic.request_count(mix, seconds))
    too_long = [r["id"] for r in reqs if system.prompt_len(r) > 64]
    if too_long:
        raise ValueError(f"prompts {too_long[:5]} exceed the first prefill "
                         "bucket (64 tokens)")
    log("system built; warming up")
    system.warm(_vocode_latents(mix) if mix["loop"] == "closed" else [],
                windows=mix["loop"] == "open")
    log("warm; traffic starts")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    if mix["loop"] == "closed":
        driver = traffic.ClosedLoop(
            mix, reqs, traffic.first_shares(mix, seed, mix["clients"]),
            system.serve_backlog)
    else:
        driver = traffic.OpenLoop(mix, reqs,
                                  traffic.arrivals(mix, seed, len(reqs)),
                                  system.serve_stream)
    t_traffic = traffic.now()
    driver.start()
    w0 = t_traffic + mix["ramp_s"]
    _sleep_until(w0)
    if traced:
        system.instrument()
    setup_s = w0 - t_start
    log(f"window opens (setup {setup_s:.1f} s)")
    blocks0 = system.blocks()
    occ: List[int] = []
    stop_sampling = threading.Event()

    def sample_occupancy():
        while not stop_sampling.is_set():
            occ.append(system.live())
            stop_sampling.wait(mix["occupancy_period_s"])

    sampler = threading.Thread(target=sample_occupancy, daemon=True)
    sampler.start()
    w1 = w0 + seconds
    _sleep_until(w1)
    log("window closes")
    blocks = system.blocks() - blocks0
    stop_sampling.set()
    sampler.join()
    tr = got = None
    if traced and dev.type == "cuda":
        # the device trace follows the window, under the same traffic:
        # stopping the profiler holds the interpreter for seconds, which
        # the window's own readings must not see; an open loop's requests
        # due in the window finish first (the trace's quiet stops would
        # stall them)
        if mix["loop"] == "open":
            _drain(driver.records, w0, w1, w1 + mix["drain_s"])
        log("trace starts")
        got = trace.capture(mix["trace_s"], system.quiet)
        log("trace stopped")
    if mix["loop"] == "closed":
        driver.stop(system.cancel_all)
    else:
        driver.stop(system.cancel_all, w1 + mix["drain_s"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    system.close()
    log("traffic stopped")
    if got is not None:
        res, a, b = got
        # the operations that started in the traced span (not those of the
        # quiet stretches around it)
        kernels = [k for k in trace.kernels(res) if a <= k[1] < b]
        tr = trace.summary(kernels, a, b, system.spans)
        tr["kernels"] = kernels
        # a block dispatched up to 2 s before the trace may still run in it
        buckets = [n for k, s0, s1, n in system.spans
                   if k == "dispatch" and s1 > a - 2.0 and s0 < b]
        tr["min_bucket"] = min(buckets) if buckets else None
        log(f"trace read: {len(kernels)} device operations")

    rv = types.SimpleNamespace(
        window=(w0, w1), records=driver.records, occupancy=occ,
        blocks=blocks, spans=list(system.spans), trace=tr, config=cfg,
        mix=mix, setup_s=setup_s)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = cell.reader(m["name"])(rv)
        if v is not None:
            metrics[m["name"]] = {"value": finite(float(v)),
                                  "unit": m["unit"]}
    judged_recs = judged(rv)
    attempted = len(judged_recs)
    failed = sum(1 for r in judged_recs
                 if r["failed"] or "t_done" not in r)

    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log("check starts")
    got = check.readings(judged_recs, cfg, mix, seed, dev)
    log("check done")
    limits = cfg["limits"]
    checks = {n: {"value": finite(got["numbers"][n]), "limit": limits[n]}
              for n in check.NUMBERS}
    out = {"correct": check.verdict(got["numbers"], limits) and attempted > 0,
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info(dev, peak, tr)}
    if tr is not None:
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checked"] = {"requests": got["checked"], "tokens": got["tokens"]}
    out["checks"] = checks
    return out


def device_info(dev, peak: int, tr: Optional[dict]) -> Dict[str, object]:
    if dev.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        info["busy_s"] = tr["busy_s"]
        info["window_s"] = tr["window_s"]
    return info

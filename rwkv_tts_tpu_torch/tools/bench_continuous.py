"""Serving benchmark of the continuous engine: the port's counterpart of
the JAX package's ``tools/bench_continuous.py``, the concurrency row of
``BASELINE.md`` (64 concurrent mixed-length requests).

The configuration is the JAX tool's: a ``ContinuousEngine`` at 128 slots,
block 32, ``max_semantic_tokens`` 512, over ``make_serving_params`` (int8
weights, the raw projections) with a bf16 state; 64 requests of 6–16
words, seeds 1000 + i, token caps 128 / 256 / 384 / 512 round-robin, each
``submit``-ted on its own. Before the timed region the engine's
``warmup(max_burst=min(n, slots))`` runs every admission burst and decode
bucket the run can touch at the engine's first two prefill buckets, as a
production server warms at startup (on a card it captures their graphs),
and the vocoder decodes one padded sub-batch. Then every utterance is
vocoded, padded to 512 latents, in sub-batches of 8 (``bicodec.decode``;
8 × 512 latents are past ``DECODE_GRAPH_MAX_LATENTS``, so it runs eagerly,
as the pipeline's ``DecodeGraphs`` would).

Prints one JSON line with the JAX tool's keys (``requests`` …
``loop_stats``, ``backend`` "cuda" or "cpu"); on a card also the warm-ups'
seconds, the engine's graph pool MiB, the programs captured inside the
timed region, the buckets its blocks ran on, and the device busy ms and
kernels a step of one block at the largest of them (``torch.profiler``
over the block's draws and two steps, after the run).
``--caps``, ``--pad`` and ``--warm-burst`` cut the depth (the tests and
``chip_smoke.py``); the defaults are the JAX tool's. A ``--warm-burst``
below the largest burst the traffic admits leaves that burst's prefill to
be captured inside the timed region.

    python -m rwkv_tts_tpu_torch.tools.bench_continuous [n_requests]
        [slots] [block] [--caps 128,256,384,512] [--pad 512]
        [--warm-burst N]
        [--layers 32] [--embd 2048] [--tiny-codec]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from ..config import EngineConfig, RwkvConfig, TtsArgs
from ..models import bicodec
from ..runtime.continuous import ContinuousEngine
from ..utils.device import resolve_device
from ._timing import Launches, busy, card_name
from .profile_buckets import serving_cfg, serving_params
from .profile_first_chunk import serving_codec

WORDS = ("the quick brown fox jumps over the lazy dog and keeps "
         "running through the moonlit field without a pause").split()
VOCODE_BATCH = 8


def _args(argv):
    p = argparse.ArgumentParser(prog="bench_continuous",
                                description=__doc__.splitlines()[0])
    p.add_argument("n_requests", type=int, nargs="?", default=64)
    p.add_argument("slots", type=int, nargs="?", default=128)
    p.add_argument("block", type=int, nargs="?", default=32)
    p.add_argument("--caps", default="128,256,384,512",
                   help="the requests' token caps, round-robin")
    p.add_argument("--pad", type=int, default=512,
                   help="latents each utterance is padded to for the vocoder")
    p.add_argument("--warm-burst", type=int, default=None,
                   help="the warm-up's largest burst (default: "
                        "min(n_requests, slots))")
    p.add_argument("--layers", type=int, default=RwkvConfig.n_layer)
    p.add_argument("--embd", type=int, default=RwkvConfig.n_embd)
    p.add_argument("--tiny-codec", action="store_true",
                   help="BiCodecConfig.tiny() instead of the full codec")
    return p.parse_args(argv)


def requests(n: int, caps: Sequence[int]) -> List[TtsArgs]:
    """The JAX tool's traffic: texts of 6–16 words, seeds 1000 + i, the
    caps round-robin."""
    return [TtsArgs(text=" ".join(WORDS[:6 + (i % 11)]), seed=1000 + i,
                    max_tokens=caps[i % len(caps)]) for i in range(n)]


def log_block_slots(eng: ContinuousEngine) -> List[int]:
    """A list that grows by the slots each of ``eng``'s decode blocks runs
    on (its bucket, or all of them), eager or graphed."""
    seen, real = [], eng._decode

    def logged(bucket):
        seen.append(min(bucket, eng.B))
        return real(bucket)

    eng._decode = logged
    return seen


def vocode(bc, bc_cfg, results, pad: int, device: torch.device):
    """Every utterance padded to ``pad`` latents, in sub-batches of 8;
    returns the last sub-batch's waveform."""
    wav = None
    for i in range(0, len(results), VOCODE_BATCH):
        batch = results[i:i + VOCODE_BATCH]
        sem = np.zeros((len(batch), pad), np.int64)
        g = np.zeros((len(batch), C.GLOBAL_TOKENS_SIZE), np.int64)
        for j, r in enumerate(batch):
            toks = r.semantic_tokens[:pad]
            sem[j, :len(toks)] = toks
            g[j, :len(r.global_tokens)] = r.global_tokens
        wav = bicodec.decode(bc, torch.from_numpy(g).to(device),
                             torch.from_numpy(sem).to(device), bc_cfg)
    return wav


def block_busy(eng: ContinuousEngine, bucket: int,
               device: torch.device) -> Dict:
    """Busy ms and kernels a step of one graphed block on the first
    ``bucket`` slots: its draws and two steps, replayed on the stopped
    engine's buffers."""
    draws, step = eng.graphs.programs(bucket)

    def two_steps():
        draws.replay()
        step.replay()
        step.replay()

    b = busy(two_steps, device, per=2)
    return {"busy_ms": b["device_ms"], "kernels": b["kernels"]}


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    a = _args(argv)
    dev = resolve_device(device)
    caps = [int(c) for c in a.caps.split(",")]
    cfg = serving_cfg(a.layers, a.embd)
    params = serving_params(cfg, dev)
    bc, bc_cfg = serving_codec(a.tiny_codec, dev)
    eng = ContinuousEngine(
        params, cfg, EngineConfig(max_semantic_tokens=max(caps + [a.pad]),
                                  batch_size=a.slots),
        block=a.block, slots=a.slots, device=dev)
    reqs = requests(a.n_requests, caps)
    launches = Launches()

    def synced():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    warm_burst = a.warm_burst or min(a.n_requests, a.slots)
    t0 = time.perf_counter()
    eng.warmup(max_burst=warm_burst)
    warmup_s = time.perf_counter() - t0
    print(f"  engine warm-up (captures): {warmup_s:.1f}s", file=sys.stderr,
          flush=True)
    t0 = time.perf_counter()
    bicodec.decode(bc, torch.zeros((VOCODE_BATCH, C.GLOBAL_TOKENS_SIZE),
                                   dtype=torch.int64, device=dev),
                   torch.zeros((VOCODE_BATCH, a.pad), dtype=torch.int64,
                               device=dev), bc_cfg)
    synced()
    vocoder_warmup_s = time.perf_counter() - t0
    print(f"  vocoder warm-up: {vocoder_warmup_s:.1f}s", file=sys.stderr,
          flush=True)
    stats0 = dict(eng.stats)
    warm_graphs = 0 if eng.graphs is None else len(eng.graphs.cache.programs)
    block_slots = log_block_slots(eng)

    results: List[object] = [None] * a.n_requests
    done = threading.Event()
    remaining = [a.n_requests]
    lock = threading.Lock()

    def cb(i):
        def _cb(res):
            results[i] = res
            with lock:
                remaining[0] -= 1
                if remaining[0] == 0:
                    done.set()
        return _cb

    t0 = time.perf_counter()
    try:
        for i, r in enumerate(reqs):
            eng.submit(r, cb(i))
        if not done.wait(timeout=3600):
            raise TimeoutError("continuous benchmark timed out")
        wall_llm = time.perf_counter() - t0
    finally:
        eng.stop()
    errors = [r for r in results if isinstance(r, Exception)]
    if errors:
        raise RuntimeError(
            f"{len(errors)}/{a.n_requests} requests failed; first: "
            f"{type(errors[0]).__name__}: {errors[0]}")
    tok_counts = [len(r.semantic_tokens) for r in results]
    audio_sec = sum(tok_counts) / C.TOKENS_PER_SECOND

    t0 = time.perf_counter()
    wav = vocode(bc, bc_cfg, results, a.pad, dev)
    synced()
    wall_detok = time.perf_counter() - t0
    if not bool(torch.isfinite(wav).all()):
        raise RuntimeError("the vocoded waveform is not finite")
    wall_e2e = wall_llm + wall_detok
    out = {
        "backend": dev.type,
        "requests": a.n_requests,
        "slots": a.slots,
        "block": a.block,
        "token_caps": caps,
        "tokens_total": int(sum(tok_counts)),
        "audio_sec": audio_sec,
        "wall_s_llm": wall_llm,
        "wall_s_detok": wall_detok,
        "xrt_continuous_llm": audio_sec / wall_llm,
        "xrt_continuous_e2e": audio_sec / wall_e2e,
        # timed-region deltas only (the warm-ups excluded)
        "loop_stats": {k: v - stats0[k] for k, v in eng.stats.items()},
        "tool": "bench_continuous", "device": card_name(dev),
        "L": cfg.n_layer, "C": cfg.n_embd, "pad": a.pad, "quant": "int8",
        "state_dtype": cfg.state_dtype,
        "codec": "tiny" if a.tiny_codec else "full",
        "warmup_s": warmup_s, "vocoder_warmup_s": vocoder_warmup_s,
        "block_buckets": sorted(set(block_slots)),
        "warm_burst": warm_burst,
        "tokens_by_request": tok_counts,
    }
    if eng.graphs is not None:
        out["graph_pool_mib"] = sum(
            p.stats["pool_bytes"] for p in eng.graphs.cache.programs.values()
        ) / 2 ** 20
        out["graphs"] = len(eng.graphs.cache.programs)
        # captured after the warm-up: by the timed region (the block
        # profile below replays programs it already holds)
        out["timed_captures"] = out["graphs"] - warm_graphs
        out["block_step"] = dict(block_busy(eng, max(block_slots), dev),
                                 bucket=max(block_slots))
    out["launches"] = launches.delta()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

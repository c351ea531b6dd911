"""Serving soak: mixed traffic against the port's HTTP server, the port's
counterpart of the JAX package's ``tools/soak_serving.py``.

It drives the serving stack end to end on the card: the full-width LM in
the JAX serving layout (random int8 weights, the raw projections, a bf16
state: throughput and robustness depend on the widths, not the values),
the full-size BiCodec, the tool's 2-layer wav2vec2, the shipped voices
(``assets/raf``), and the server (``server/app.py``) with its batcher and
its continuous engine (16 slots, an occupancy bucket of 8, the server's
stream block of 16), under concurrent mixed traffic from ``--concurrency``
client threads:

  * normal-mode synthesis (texts of 5-13 words, seeds, emotions, speeds);
  * zero-shot synthesis by a shipped ``voice_id``;
  * NDJSON streams in the low, ultra and flash modes, a third of them
    abandoned after their first chunk (the cancel path under load);
  * a ``/metrics`` scrape every snapshot.

The traffic is the JAX tool's (``random.Random(7)``, ``WORDS``,
``EMOTIONS``, ``KINDS``, ``MODES``, ``ABORT_SHARE``). The port's server
is the standard library's, so the client is ``http.client`` with one
thread per request in flight, as the server has one per connection; an
abandoned stream closes its connection.

Every ``--snapshot-every`` seconds it records the JAX tool's snapshot:
the window's client-side first-chunk and request-latency p50/p99, the
server-side stage means over the window (``/metrics`` histograms), the
process's RSS, the continuous engine's live slots and crash flag, and the
running counts; on a card also the card's reserved MiB, the CUDA graphs'
pools and the programs captured so far (``card``). Afterwards it checks
``/healthz``, waits for the slots to drain, prints one JSON document and a
markdown table, and exits 1 unless ``soak_ok`` (no error, ``/healthz``
200, every slot drained, no crash).

    python -m rwkv_tts_tpu_torch.tools.soak_serving [--minutes 31]
        [--port 3210] [--snapshot-every 180] [--concurrency 6] [--warmup]
        [--max-tokens 256]
    python -m rwkv_tts_tpu_torch.tools.soak_serving --minutes 2 --light
        (tiny models: a quick smoke of the harness; with
        RWKV_TTS_PLATFORM=cpu, or ``main(argv, device="cpu")``, on the CPU)
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import http.client
import json
import os
import random
import re
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

WORDS = ("the quick brown fox jumps over the lazy dog while rain keeps "
         "falling on the quiet field and nobody notices the time pass "
         "until morning light returns softly").split()
EMOTIONS = ["NEUTRAL", "HAPPY", "SAD", "ANGRY", "SURPRISED"]
# each worker's request kinds, in turn (the JAX tool's cycle)
KINDS = ["normal", "stream", "zero_shot", "normal", "stream"]
MODES = ["low", "ultra", "flash"]
SPEEDS = ["slow", "medium", "fast"]
ABORT_SHARE = 0.33       # streams abandoned after their first chunk
STAGES = ("queue_wait", "first_emit", "first_chunk")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def _pct(xs, q):
    if not xs:
        return None
    return round(float(np.percentile(np.asarray(xs), q)), 1)


def build_app(light: bool, device=None, max_tokens: Optional[int] = None):
    """The JAX tool's app on the port: full width in the serving layout
    (or, ``light``, 2 × 256 f32 with the tiny codec), the tool's 2-layer
    wav2vec2, the shipped voices, ``EngineConfig(max_semantic_tokens=256,
    batch_size=16)`` (16 and 2 light; ``max_tokens`` overrides the first)
    and ``BatchConfig(8, 10 ms, 600000 ms)``. Weights from seeds 0, 1, 2."""
    import torch

    from ..config import (BatchConfig, BiCodecConfig, EngineConfig,
                          RwkvConfig, Wav2Vec2Config)
    from ..models import bicodec, rwkv7, wav2vec2
    from ..runtime.pipeline import TtsPipeline
    from ..runtime.voice_store import VoiceStore
    from ..server.app import create_app
    from ..utils.device import resolve_device

    dev = resolve_device(device)

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    if light:
        lm_cfg = RwkvConfig(n_layer=2, n_embd=256, head_size=64,
                            dtype="float32", param_dtype="float32")
        lm_params = rwkv7.init_params(lm_cfg, gen(0), dev)
        bc_cfg = BiCodecConfig.tiny(feat_dim=32)
    else:
        lm_cfg = dataclasses.replace(RwkvConfig(), state_dtype="bfloat16")
        lm_params = rwkv7.make_serving_params(lm_cfg, gen(0), quant="int8",
                                              device=dev)
        bc_cfg = BiCodecConfig()
    bc_params = bicodec.init_params(bc_cfg, gen(1), dev)
    w2v_cfg = Wav2Vec2Config(num_layers=2, hidden_size=bc_cfg.feat_dim,
                             num_heads=2, ffn_size=64, conv_dims=(16,) * 7)
    w2v_params = wav2vec2.init_params(w2v_cfg, gen(2), dev)
    if max_tokens is None:
        max_tokens = 16 if light else 256
    pipe = TtsPipeline(
        lm_params, lm_cfg, bc_params, bc_cfg, w2v_params, w2v_cfg,
        voice_store=VoiceStore(os.path.join(REPO, "assets", "raf")),
        engine_cfg=EngineConfig(max_semantic_tokens=max_tokens,
                                batch_size=2 if light else 16),
        w2v_output_layers=(1, 2), device=dev)
    return create_app(pipe, BatchConfig(max_batch_size=8,
                                        collect_timeout_ms=10,
                                        inference_timeout_ms=600000))


def warm_app(app):
    """The server's --warmup: the pipeline's programs and the continuous
    engine's admission and decode buckets, before any traffic."""
    from ..server.app import _get_continuous

    t0 = time.perf_counter()
    times = app["pipeline"].warmup()
    _get_continuous(app).warmup()
    print(f"warmup: {time.perf_counter() - t0:.1f}s "
          f"({len(times)} pipeline programs)", file=sys.stderr, flush=True)


@contextlib.contextmanager
def serving(app, port: int):
    """``app`` served on 127.0.0.1:``port`` (0: any free port) from a
    thread while inside; yields the port. The app itself is not closed."""
    from ..server.app import make_server

    srv = make_server(app, "127.0.0.1", port)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="soak-server")
    t.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)


def get(port: int, path: str, timeout: float = 60.0):
    """GET ``path``: (status, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def post(port: int, path: str, body: dict, timeout: float = 1800.0):
    """POST a JSON body: (status, decoded JSON or the raw text)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read()
        try:
            return r.status, json.loads(raw)
        except ValueError:
            return r.status, raw.decode(errors="replace")
    finally:
        conn.close()


def metrics_map(text: str) -> Dict[str, str]:
    return dict(re.findall(r"^rwkv_tts_(\S+) (\S+)$", text, re.MULTILINE))


def stage_means(text: str, prev: dict) -> Dict[str, Optional[float]]:
    """Server-side stage attribution from the ``/metrics`` histograms: the
    mean ms of each serving stage over the window (delta of _sum over
    delta of _count since the last call, which ``prev`` remembers)."""
    out = {}
    for stage in STAGES:
        s = re.search(rf"^rwkv_tts_stage_{stage}_seconds_sum (\S+)$", text,
                      re.MULTILINE)
        c = re.search(rf"^rwkv_tts_stage_{stage}_seconds_count (\S+)$",
                      text, re.MULTILINE)
        if not (s and c):
            continue
        ds = float(s.group(1)) - prev.get(stage + "_sum", 0.0)
        dc = float(c.group(1)) - prev.get(stage + "_count", 0)
        prev[stage + "_sum"] = float(s.group(1))
        prev[stage + "_count"] = float(c.group(1))
        out[f"{stage}_mean_ms"] = round(ds / dc * 1000.0, 1) if dc else None
    return out


def graph_caches(app) -> Dict[str, object]:
    """The app's CUDA graph caches by holder (none on the CPU)."""
    pipe = app["pipeline"]
    eng = pipe.engine
    cont = app["runtime"]["continuous"]
    found = {"stages": eng.graphs, "prefill": eng.prefill_graphs,
             "continuous": None if cont is None else cont.graphs,
             "vocoder": pipe.decode_graphs}
    return {k: h.cache for k, h in found.items()
            if h is not None and hasattr(h, "cache")}


def card_readings(app) -> Optional[Dict]:
    """On a card: MiB the caching allocator reserves, in all and in the
    CUDA graphs' private pools, and the programs each graph cache holds."""
    import torch

    if app["pipeline"].engine.device.type != "cuda":
        return None
    segs = torch.cuda.memory_snapshot()
    pools = sum(sg["total_size"] for sg in segs
                if tuple(sg["segment_pool_id"]) != (0, 0))
    return {"reserved_mib": round(torch.cuda.memory_reserved() / 2**20, 1),
            "graph_pools_mib": round(pools / 2**20, 1),
            "graphs": {k: len(c.programs)
                       for k, c in graph_caches(app).items()}}


def soak(app, minutes: float, port: int, snapshot_every: float,
         concurrency: int):
    """The JAX tool's ``soak`` on the port's server: ``concurrency``
    client threads, each cycling ``KINDS``, until ``minutes`` are up, a
    snapshot every ``snapshot_every`` s (``card_readings`` under "card"),
    then ``/healthz`` and the drain to 0 live slots. Serves ``app`` for
    its duration; returns (stats, snapshots, health, drained)."""
    with serving(app, port) as port:
        return _soak(port, minutes, snapshot_every, concurrency,
                     lambda: card_readings(app))


def _soak(port, minutes, snapshot_every, concurrency, readings):
    rng = random.Random(7)
    rng_lock = threading.Lock()
    lock = threading.Lock()
    stats = {"ok": 0, "errors": [], "aborted_streams": 0,
             "kinds": {k: 0 for k in set(KINDS)}}
    window: Dict[str, List[float]] = {"first_chunk_ms": [], "latency_ms": []}
    snapshots: List[dict] = []
    t_start = time.monotonic()
    deadline = t_start + minutes * 60.0

    status, body = get(port, "/api/voice-clone/list")
    voices = [v["id"] for v in json.loads(body).get("voices", [])] \
        if status == 200 else []

    def err(*e):
        with lock:
            stats["errors"].append(e)

    def stream(body, abort, t0):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=1800)
        try:
            conn.request("POST", "/api/tts/stream", body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            if r.status != 200:
                err("stream", r.status, r.read().decode(errors="replace"))
                return False
            n = 0
            for line in r:
                if not line.strip():
                    continue
                msg = json.loads(line)
                if msg.get("error"):
                    err("stream-line", msg)
                    return False
                if n == 0:
                    with lock:
                        window["first_chunk_ms"].append(
                            (time.monotonic() - t0) * 1e3)
                n += 1
                if abort:
                    with lock:
                        stats["aborted_streams"] += 1
                    return True         # the client walks away
                if msg.get("final"):
                    break
            return True
        finally:
            conn.close()

    def one_request(kind: str):
        with rng_lock:
            text = " ".join(rng.sample(WORDS, rng.randrange(5, 14)))
            if kind == "stream":
                abort = rng.random() < ABORT_SHARE
                body = {"text": text, "seed": rng.randrange(999),
                        "latency_mode": rng.choice(MODES)}
            else:
                body = {"text": text, "seed": rng.randrange(999),
                        "emotion": rng.choice(EMOTIONS),
                        "speed": rng.choice(SPEEDS)}
                if kind == "zero_shot" and voices:
                    body["voice_id"] = rng.choice(voices)
        t0 = time.monotonic()
        try:
            if kind == "stream":
                if not stream(body, abort, t0):
                    return
            else:
                status, j = post(port, "/api/tts", body)
                if status != 200 or not isinstance(j, dict) \
                        or not j.get("success"):
                    err("tts", status, j if isinstance(j, dict)
                        else str(j)[:200])
                    return
                base64.b64decode(j["audio_base64"])
            with lock:
                stats["ok"] += 1
                stats["kinds"][kind] += 1
                window["latency_ms"].append((time.monotonic() - t0) * 1e3)
        except Exception as e:  # noqa: BLE001: recorded, the soak goes on
            err(kind, type(e).__name__, str(e)[:200])

    def worker(wid: int):
        while time.monotonic() < deadline:
            with lock:
                ok = stats["ok"]
            one_request(KINDS[(wid + ok) % len(KINDS)])

    stage_prev: dict = {}
    stop = threading.Event()

    def snapshotter():
        while time.monotonic() < deadline:
            if stop.wait(min(snapshot_every,
                             max(1.0, deadline - time.monotonic()))):
                return
            _, raw = get(port, "/metrics")
            text = raw.decode()
            m = metrics_map(text)
            with lock:
                snap = {
                    "stages": stage_means(text, stage_prev),
                    "t_min": round((time.monotonic() - t_start) / 60, 1),
                    "rss_mb": round(_rss_mb(), 1),
                    "ok_total": stats["ok"],
                    "err_total": len(stats["errors"]),
                    "aborted_streams": stats["aborted_streams"],
                    "live_slots": int(float(m.get(
                        "continuous_live_slots", -1))),
                    "crashed": int(float(m.get("continuous_crashed", 0))),
                    "first_chunk_p50": _pct(window["first_chunk_ms"], 50),
                    "first_chunk_p99": _pct(window["first_chunk_ms"], 99),
                    "latency_p50": _pct(window["latency_ms"], 50),
                    "latency_p99": _pct(window["latency_ms"], 99),
                    "n_window": (len(window["first_chunk_ms"]),
                                 len(window["latency_ms"])),
                }
                window["first_chunk_ms"].clear()
                window["latency_ms"].clear()
            snap["card"] = readings()
            snapshots.append(snap)
            print(json.dumps(snap), flush=True)

    workers = [threading.Thread(target=worker, args=(i,), daemon=True,
                                name=f"soak-client-{i}")
               for i in range(concurrency)]
    snap_t = threading.Thread(target=snapshotter, daemon=True,
                              name="soak-snapshots")
    for t in workers:
        t.start()
    snap_t.start()
    for t in workers:
        t.join()
    stop.set()
    snap_t.join()

    # after the soak: the server still answers, the slots drain to zero
    status, raw = get(port, "/healthz")
    health = (status, json.loads(raw))
    drained = None
    for _ in range(120):
        _, raw = get(port, "/metrics")
        drained = int(float(metrics_map(raw.decode()).get(
            "continuous_live_slots", 0)))
        if drained == 0:
            break
        time.sleep(1.0)
    return stats, snapshots, health, drained


def _args(argv):
    ap = argparse.ArgumentParser(prog="soak_serving",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=31.0)
    ap.add_argument("--port", type=int, default=3210)
    ap.add_argument("--snapshot-every", type=float, default=180.0)
    ap.add_argument("--concurrency", type=int, default=6)
    ap.add_argument("--light", action="store_true",
                    help="tiny models (a smoke of the harness itself)")
    ap.add_argument("--warmup", action="store_true",
                    help="run the server's warm-up before traffic")
    ap.add_argument("--max-tokens", type=int, default=None,
                    help="EngineConfig.max_semantic_tokens (default 256, "
                         "16 with --light)")
    return ap.parse_args(argv)


def document(minutes, stats, snapshots, health, drained, extra=None
             ) -> Dict:
    """The JAX tool's final document (``soak_ok`` and its readings), plus
    the port's ``extra`` keys."""
    ok = (not stats["errors"] and health[0] == 200 and drained == 0
          and all(s["crashed"] == 0 for s in snapshots))
    return {"soak_ok": ok, "minutes": minutes,
            "requests_ok": stats["ok"],
            "aborted_streams": stats["aborted_streams"],
            "errors": stats["errors"][:10], "healthz": health,
            "slots_after_drain": drained, "snapshots": snapshots,
            **(extra or {})}


def table(snapshots) -> str:
    rows = ["| t (min) | reqs ok | errs | aborted | RSS MB | live slots | "
            "first-chunk p50/p99 ms | latency p50/p99 ms |",
            "|---|---|---|---|---|---|---|---|"]
    for s in snapshots:
        rows.append(
            f"| {s['t_min']} | {s['ok_total']} | {s['err_total']} | "
            f"{s['aborted_streams']} | {s['rss_mb']} | {s['live_slots']} | "
            f"{s['first_chunk_p50']} / {s['first_chunk_p99']} | "
            f"{s['latency_p50']} / {s['latency_p99']} |")
    return "\n".join(rows)


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    """Build, (warm,) soak, close; prints the document and the table and
    returns the document. The card unless ``device="cpu"`` is passed or,
    with no ``device``, ``RWKV_TTS_PLATFORM=cpu`` is set (the server's
    knob)."""
    from ..tools._timing import card_name
    from ..utils.device import resolve_device

    from ..server.app import device_from_env

    args = _args(argv)
    dev = resolve_device(device_from_env() if device is None else device)
    print(f"device: {card_name(dev)}", file=sys.stderr, flush=True)
    app = build_app(args.light, dev, args.max_tokens)
    try:
        if args.warmup:
            warm_app(app)
        stats, snapshots, health, drained = soak(
            app, args.minutes, args.port, args.snapshot_every,
            args.concurrency)
        after = card_readings(app)
    finally:
        app.close()
    doc = document(args.minutes, stats, snapshots, health, drained, {
        "kinds_ok": stats["kinds"], "card_after_drain": after,
        "max_semantic_tokens":
            app["pipeline"].engine.engine_cfg.max_semantic_tokens})
    print(json.dumps(doc))
    print("\n" + table(snapshots), flush=True)
    return doc


if __name__ == "__main__":
    sys.exit(0 if main()["soak_ok"] else 1)

"""HTTP serving layer of the port: REST API + embedded Web UI.

Port of ``rwkv_tts_tpu/server/app.py``, route for route and payload for
payload (reference: bin/server.rs:1445-1451):

  POST /api/tts                  {text, temperature?, top_p?, speed (number
                                  or class string), voice_id?, seed?, age?,
                                  gender?, emotion?, pitch?, prompt_text?,
                                  cached_speaker?}
                                  → {success, message, audio_base64,
                                     duration_ms, rtf, timings_ms}
  POST /api/tts/stream           same body, plus latency_mode? and
                                  low_latency?; answers with chunked NDJSON
                                  lines {seq, audio_base64 (raw s16le PCM),
                                  sample_rate, final, first_chunk_ms}
  POST /api/voice-clone/extract  multipart {voice_name, prompt_text,
                                  audio_file} → {success, message, voice_id}
  GET  /api/voice-clone/list     → {success, voices: [...]}
  POST /api/voice-clone/delete   {voice_id} → {success, message}
  POST /debug/trace              {seconds?, dir?} → a torch.profiler Chrome
                                  trace (``trace.json``) in ``trace_dir``
  GET  /healthz                  503 with ``continuous_error`` once the
                                  decode loop has crashed
  GET  /metrics                  Prometheus text
  GET  /{*path}                  the embedded static UI

The JAX server is built on aiohttp; this one needs nothing outside the
standard library: ``http.server.ThreadingHTTPServer`` speaking HTTP/1.1,
one thread per connection. The handlers are plain functions from a
``Request`` to a ``Response`` (a body, or an iterator of chunks sent with
chunked transfer encoding); ``_Handler`` does the socket work: body limit,
CORS on every response (404, 405 and ``OPTIONS`` included), the request
log. A connection's thread does its own blocking work (voice resolution,
waiting for the engine, vocoding), so no request holds up another.

``/api/tts`` is served by the continuous slot engine by default (one slot
of the decode loop the streams ride); ``--tts-engine static`` sends it
through ``runtime.batching.DynamicBatcher`` to ``synthesize_batch``, and a
crashed decode loop falls back to that path.

Run: ``python -m rwkv_tts_tpu_torch.server.app --port 3000``. It serves on
the CUDA card, and raises when there is none, unless
``RWKV_TTS_PLATFORM=cpu`` selects the CPU. ``--model-path`` names the LM
checkpoint (webrwkv.safetensors, a prefab, or a directory holding
rwkvtts-Int8_22.safetensors or webrwkv.safetensors) and the codecs come from
its directory; without a checkpoint on disk it serves random weights at
the JAX package's dev widths. At start-up the five published model files
missing from that directory are downloaded (``utils/download.py``:
``HF_ENDPOINT``, then the public mirrors), as the JAX server does, unless
``--no-download`` is given.
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import dataclasses
import email.parser
import email.policy
import http.server
import json
import logging
import mimetypes
import os
import socketserver
import sys
import tempfile
import threading
import time
import urllib.parse
import uuid
from typing import Callable, Dict, Iterator, Optional

from .. import constants as C
from ..audio.io import encode_wav_16bit
from ..config import (BatchConfig, BiCodecConfig, EngineConfig, RwkvConfig,
                      TtsArgs, Wav2Vec2Config)
from ..runtime.batching import (DynamicBatcher, InferenceTimeout,
                                settle_future)
from ..runtime.pipeline import TtsPipeline
from ..runtime.voice_store import VoiceStore
from ..utils.metrics import (LATENCY_BUCKETS, RTF_BUCKETS, STAGE_BUCKETS,
                             Histogram)

log = logging.getLogger("rwkv_tts_tpu_torch.server")

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "static")
MAX_BODY = 100 * 1024 * 1024        # aiohttp's client_max_size in the JAX app

_ALLOWED_SPEEDS = {"very_slow", "slow", "medium", "fast", "very_fast"}
LATENCY_MODES = ("exact", "low", "ultra", "flash")


def coerce_speed(value) -> str:
    """Accept a class string or a number (server thresholds differ from the
    property classifier — bin/server.rs:528-554: ≤3.4 / ≤4.0 / ≤4.5 / ≤4.8)."""
    if value is None:
        return "medium"
    if isinstance(value, str):
        return value if value in _ALLOWED_SPEEDS else "medium"
    try:
        x = float(value)
    except (TypeError, ValueError):
        return "medium"
    if x <= 3.4:
        return "very_slow"
    if x <= 4.0:
        return "slow"
    if x <= 4.5:
        return "medium"
    if x <= 4.8:
        return "fast"
    return "very_fast"


def build_tts_args(payload: dict) -> TtsArgs:
    return TtsArgs(
        text=str(payload.get("text", "")),
        temperature=float(payload.get("temperature") or 1.0),
        top_p=float(payload.get("top_p") or 0.95),
        top_k=100,                         # hardcoded like the reference (:556-584)
        max_tokens=8000,
        seed=(int(payload["seed"]) if payload.get("seed") is not None else None),
        voice_id=payload.get("voice_id") or None,
        prompt_text=str(payload.get("prompt_text") or ""),
        age=str(payload.get("age") or "youth-adult"),
        gender=str(payload.get("gender") or "female"),
        emotion=str(payload.get("emotion") or "NEUTRAL"),
        pitch=str(payload.get("pitch") or "medium_pitch"),
        speed=coerce_speed(payload.get("speed")),
        # absent → the server default (--cached-speaker); an explicit
        # true/false overrides it per request
        cached_speaker=(bool(payload["cached_speaker"])
                        if payload.get("cached_speaker") is not None
                        else None),
    )


# --------------------------------------------------------------------------
# requests and responses
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    app: "App"
    method: str
    path: str
    headers: object          # http.client.HTTPMessage: case-insensitive
    body: bytes = b""

    def json(self) -> dict:
        """The body as a JSON object; ``ValueError`` when it is not one."""
        payload = json.loads(self.body.decode("utf-8"))
        if not isinstance(payload, dict):
            raise ValueError("the JSON body is not an object")
        return payload


@dataclasses.dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/octet-stream"
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)
    # set for a streamed body: each item goes out as one HTTP/1.1 chunk;
    # the handler closes the iterator when the client goes away
    chunks: Optional[Iterator[bytes]] = None


def json_response(obj, status: int = 200) -> Response:
    return Response(status, json.dumps(obj).encode(),
                    "application/json; charset=utf-8")


def _err(msg: str, status: int = 500) -> Response:
    return json_response({"success": False, "error": msg, "message": msg},
                         status=status)


def _text(status: int, reason: str, **headers) -> Response:
    """aiohttp's plain-text error bodies ("405: Method Not Allowed")."""
    return Response(status, f"{status}: {reason}".encode(),
                    "text/plain; charset=utf-8", dict(headers))


# --------------------------------------------------------------------------
# handlers
# --------------------------------------------------------------------------

def _validate_voice(app, args: TtsArgs) -> None:
    """HTTP-layer voice_id validation, like the reference server
    (bin/server.rs:498-500 errors the request): the pipeline falls back
    down the voice chain on a bad id (library parity), so without this
    check an HTTP typo would silently synthesize the default voice."""
    if args.voice_id:
        store = app["voice_store"]
        if store is None:
            raise FileNotFoundError(f"voice not found: {args.voice_id}")
        store.load(args.voice_id)      # raises FileNotFoundError on miss


def handle_tts(request: Request) -> Response:
    app = request.app
    try:
        payload = request.json()
    except ValueError:
        return _err("invalid JSON body", status=400)
    text = str(payload.get("text", "")).strip()
    if not text:
        return _err("text is required", status=400)
    try:
        args = build_tts_args(payload)
    except (TypeError, ValueError) as e:
        return _err(f"invalid parameter: {e}", status=400)
    t0 = time.perf_counter()
    try:
        _validate_voice(app, args)
        cont = app["runtime"]["continuous"]
        use_cont = (app["tts_engine_mode"] == "continuous"
                    # graceful degradation: a crashed decode loop fails
                    # every submit, but the static engine still works —
                    # keep serving (healthz reports 503 meanwhile, so an
                    # orchestrator recycles the process)
                    and not (cont is not None and cont._crashed is not None))
        if use_cont:
            result = _tts_via_continuous(app, args)
        else:
            result = app["batcher"].submit(args)
    except InferenceTimeout as e:
        return _err(str(e), status=504)
    except FileNotFoundError as e:
        return _err(str(e), status=404)
    except Exception as e:  # noqa: BLE001: the request's boundary
        log.exception("tts failed")
        return _err(f"synthesis failed: {e}", status=500)
    wav = encode_wav_16bit(result.audio, result.sample_rate)
    dur_ms = int((time.perf_counter() - t0) * 1000)
    with app["metrics_lock"]:
        app["metrics"]["tts_requests"] += 1
        app["metrics"]["tts_audio_seconds"] += \
            len(result.audio) / result.sample_rate
    app["hist_latency"].observe(dur_ms / 1000.0)
    app["hist_rtf"].observe(result.rtf)
    return json_response({
        "success": True,
        "message": "ok",
        "audio_base64": base64.b64encode(wav).decode(),
        "duration_ms": dur_ms,
        "rtf": result.rtf,
        "timings_ms": result.timings_ms,
    })


class _Flight:
    """A request on the continuous engine that ``App.close`` must end: it
    cancels the request and waits for its handler to finish."""

    def __init__(self, cont, args: TtsArgs):
        self.cont = cont
        self.args = args
        self.abandoned = threading.Event()
        self.ended = threading.Event()

    def abandon(self) -> None:
        self.abandoned.set()
        try:
            self.cont.cancel(self.args)
        except Exception:  # noqa: BLE001: the engine may be stopping too
            log.exception("cancel on close failed")


def _register(app, flight: _Flight) -> None:
    with app["runtime"]["flights_lock"]:
        app["runtime"]["flights"].add(flight)


def _unregister(app, flight: _Flight) -> None:
    with app["runtime"]["flights_lock"]:
        app["runtime"]["flights"].discard(flight)
    flight.ended.set()


def _tts_via_continuous(app, args: TtsArgs):
    """One non-streaming /api/tts request through the continuous slot
    engine: it takes one slot of the decode loop the streams ride, so a
    long request batch and a stream interleave at block granularity. The
    engines are token-identical (tests/test_torch_continuous.py), so the
    routing is a serving choice, not a numerics change."""
    pipe: TtsPipeline = app["pipeline"]
    # on this connection's thread: a cached-speaker miss or a reference
    # file runs device work here, holding up no other request
    resolved = pipe.resolve_voice(args)
    cont = _get_continuous(app)
    fut: concurrent.futures.Future = concurrent.futures.Future()

    def done(res):
        if isinstance(res, Exception):
            settle_future(fut, exc=res)
        else:
            settle_future(fut, result=res)

    flight = _Flight(cont, resolved)
    _register(app, flight)
    try:
        t_gen = time.perf_counter()
        cont.submit(resolved, done)
        timeout_s = app["batch_cfg"].inference_timeout_ms / 1000.0
        try:
            gen = fut.result(timeout=timeout_s)
        except concurrent.futures.TimeoutError:
            # retire the slot (live) or drop it from the admission queue
            # (pending): never keep decoding for a caller that gave up
            cont.cancel(resolved)
            raise InferenceTimeout(
                f"inference exceeded {timeout_s * 1000.0:.0f} ms") from None
    finally:
        _unregister(app, flight)
    gen_ms = (time.perf_counter() - t_gen) * 1000.0
    t_voc = time.perf_counter()
    wav = pipe.vocode(gen)
    detok_ms = (time.perf_counter() - t_voc) * 1000.0
    return pipe.assemble_result(
        gen, wav, {"generate": round(gen_ms, 1),
                   "detokenize": round(detok_ms, 1)})


def _get_continuous(app):
    """Build (once) or return the continuous slot engine sharing the
    pipeline's LM; concurrent first requests build one engine."""
    rt = app["runtime"]
    if rt["continuous"] is None:
        with rt["lock"]:
            if rt["continuous"] is None:
                from ..runtime.continuous import ContinuousEngine
                eng = app["pipeline"].engine
                # it also serves non-streaming /api/tts, so it offers at
                # least the concurrency the batcher was configured for
                slots = max(eng.engine_cfg.batch_size,
                            app["batch_cfg"].max_batch_size)
                if eng.tp_mesh is not None:
                    # --tp: the continuous engine runs the sharded program
                    # over the same mesh; its slots tile the data axis
                    dp = eng.tp_mesh.dp
                    slots = max(slots, dp) - (max(slots, dp) % dp) or dp
                rt["continuous"] = ContinuousEngine(
                    eng.params, eng.cfg, eng.engine_cfg,
                    tokenizer=eng.tokenizer,
                    # --stream-block: streaming chunks leave per decode
                    # block, so a block of 8 lets flash mode (12 tokens to
                    # its first sound) emit a block earlier
                    block=app["stream_block"], slots=slots,
                    device=eng.device, mesh=eng.tp_mesh)
    return rt["continuous"]


def handle_tts_stream(request: Request) -> Response:
    """Chunked streaming synthesis over the continuous engine."""
    app = request.app
    try:
        payload = request.json()
    except ValueError:
        return _err("invalid JSON body", status=400)
    text = str(payload.get("text", "")).strip()
    if not text:
        return _err("text is required", status=400)
    try:
        args = build_tts_args(payload)
        _validate_voice(app, args)
        args = app["pipeline"].resolve_voice(args)
    except (TypeError, ValueError) as e:
        return _err(f"invalid parameter: {e}", status=400)
    except FileNotFoundError as e:
        return _err(str(e), status=404)
    latency_mode = payload.get("latency_mode")
    if latency_mode is not None and latency_mode not in LATENCY_MODES:
        return _err("latency_mode must be exact|low|ultra|flash", status=400)
    cont = _get_continuous(app)
    return Response(200, content_type="application/x-ndjson",
                    headers={"Cache-Control": "no-cache"},
                    chunks=_stream_lines(
                        app, cont, args, latency_mode,
                        bool(payload.get("low_latency", False))))


def _stream_lines(app, cont, args: TtsArgs, latency_mode, low_latency: bool):
    """The stream's NDJSON lines, produced on the connection's thread. The
    handler closes this generator when a write fails (the client went
    away): the slot is then cancelled, so the engine stops generating for
    nobody. A producer-side error (vocoder failure, stream timeout)
    cancels the slot too and ends the stream with an error line."""
    import numpy as np

    from ..runtime.streaming import stream_synthesize

    pipe: TtsPipeline = app["pipeline"]
    flight = _Flight(cont, args)
    _register(app, flight)
    ended = False
    t0 = time.perf_counter()
    first_chunk_ms = None
    it = stream_synthesize(cont, pipe.bicodec_params, pipe.bicodec_cfg, args,
                           low_latency=low_latency, latency_mode=latency_mode,
                           vocoder_graphs=pipe.decode_graphs)
    try:
        while not flight.abandoned.is_set():
            try:
                item = next(it)
            except StopIteration:
                break
            except Exception as e:  # noqa: BLE001: reported in the stream
                cont.cancel(args)
                if not flight.abandoned.is_set():
                    yield json.dumps({"error": str(e),
                                      "final": True}).encode() + b"\n"
                break
            pcm = np.clip(item.audio, -1.0, 1.0)
            pcm16 = (pcm * 32767.0).astype("<i2").tobytes()
            if first_chunk_ms is None and len(pcm16):
                first_chunk_ms = (time.perf_counter() - t0) * 1000.0
                app["hist_first_chunk"].observe(first_chunk_ms / 1000.0)
            yield json.dumps({
                "seq": item.seq,
                "audio_base64": base64.b64encode(pcm16).decode(),
                "sample_rate": C.SAMPLE_RATE,
                "final": item.final,
                "first_chunk_ms": round(first_chunk_ms, 1)
                if item.final and first_chunk_ms else None,
            }).encode() + b"\n"
            if item.final:
                break
        ended = True
    finally:
        if not ended or flight.abandoned.is_set():
            # the client went away mid-stream (GeneratorExit at a yield),
            # or the server is closing
            cont.cancel(args)
        it.close()
        _unregister(app, flight)
    with app["metrics_lock"]:
        app["metrics"]["tts_stream_requests"] = \
            app["metrics"].get("tts_stream_requests", 0) + 1


def _multipart(request: Request) -> Dict[str, tuple]:
    """``multipart/form-data`` → {field name: (filename or None, bytes)},
    split on the boundary (``cgi`` is gone from the standard library)."""
    ctype = request.headers.get("Content-Type", "")
    head = email.parser.HeaderParser(policy=email.policy.HTTP).parsestr(
        f"Content-Type: {ctype}\r\n\r\n")
    boundary = head.get_param("boundary")
    if head.get_content_type() != "multipart/form-data" or not boundary:
        raise ValueError("expected a multipart/form-data body")
    delim = b"--" + boundary.encode("latin-1")
    fields = {}
    for part in request.body.split(delim)[1:]:
        if part.startswith(b"--"):
            break                                   # the closing delimiter
        part = part[2:] if part.startswith(b"\r\n") else part
        headers, sep, data = part.partition(b"\r\n\r\n")
        if not sep:
            raise ValueError("malformed multipart part")
        if data.endswith(b"\r\n"):
            data = data[:-2]
        h = email.parser.BytesHeaderParser(policy=email.policy.HTTP) \
            .parsebytes(headers + b"\r\n\r\n")
        name = h.get_param("name", header="content-disposition")
        if name is not None:
            fields[name] = (h.get_filename(), data)
    return fields


def handle_voice_extract(request: Request) -> Response:
    app = request.app
    tmp_path = None
    try:
        fields = _multipart(request)
        voice_name = fields.get("voice_name", (None, b""))[1] \
            .decode("utf-8").strip()
        prompt_text = fields.get("prompt_text", (None, b""))[1] \
            .decode("utf-8").strip()
        if "audio_file" in fields:
            fn, data = fields["audio_file"]
            suffix = ".mp3" if (fn or "").lower().endswith(".mp3") else ".wav"
            fd, tmp_path = tempfile.mkstemp(
                prefix=f"voice_{uuid.uuid4().hex[:8]}_", suffix=suffix)
            with os.fdopen(fd, "wb") as f:
                f.write(data)
        if not voice_name:
            return _err("voice_name is required", status=400)
        if tmp_path is None:
            return _err("audio_file is required", status=400)
        feat = app["pipeline"].enroll_voice(tmp_path, voice_name, prompt_text)
        with app["metrics_lock"]:
            app["metrics"]["voices_extracted"] += 1
        return json_response({
            "success": True, "message": "voice extracted",
            "voice_id": feat.id,
        })
    except Exception as e:  # noqa: BLE001: the request's boundary
        log.exception("voice extract failed")
        return _err(f"voice extraction failed: {e}", status=500)
    finally:
        if tmp_path and os.path.exists(tmp_path):
            os.remove(tmp_path)


def handle_voice_list(request: Request) -> Response:
    store: VoiceStore = request.app["voice_store"]
    if store is None:  # store-less pipeline: an empty library, not a 500
        return json_response({"success": True, "voices": []})
    return json_response({"success": True, "voices": store.list()})


def handle_voice_delete(request: Request) -> Response:
    store: VoiceStore = request.app["voice_store"]
    try:
        vid = request.json()["voice_id"]
    except (ValueError, KeyError):
        return _err("voice_id is required", status=400)
    if store is None:
        return _err(f"voice not found: {vid}", status=404)
    ok = store.delete(vid)
    return json_response({
        "success": ok,
        "message": "deleted" if ok else f"voice not found: {vid}",
    }, status=200 if ok else 404)


def handle_trace(request: Request) -> Response:
    """On-demand profiling: POST /debug/trace {"seconds": 3} records
    ``torch.profiler`` (the host and, on a card, CUPTI's device activity)
    over that window and writes a Chrome trace, ``trace.json``, into the
    directory it returns. The profiler is process-wide: one trace at a
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    app = request.app
    try:
        payload = request.json()
    except ValueError:
        payload = {}
    seconds = float(payload.get("seconds", 3.0))
    seconds = min(max(seconds, 0.5), 60.0)
    out_dir = payload.get("dir") or os.path.join(
        tempfile.gettempdir(), f"rwkv_tts_trace_{int(time.time())}")
    lock = app["runtime"]["trace_lock"]
    if not lock.acquire(blocking=False):
        return _err("a trace is already running", status=409)
    try:
        os.makedirs(out_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if app["pipeline"].device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            time.sleep(seconds)
            if app["pipeline"].device.type == "cuda":
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    finally:
        lock.release()
    return json_response({"success": True, "trace_dir": out_dir,
                          "seconds": seconds})


def handle_healthz(request: Request) -> Response:
    app = request.app
    cont = app["runtime"]["continuous"]
    # a crashed decode loop breaks /api/tts/stream (and /api/tts falls
    # back to the static engine): report degraded (503) so an
    # orchestrator recycles the process
    crashed = cont is not None and cont._crashed is not None
    cfg = app["pipeline"].engine.cfg
    body = {
        "status": "degraded" if crashed else "ok",
        "uptime_s": round(time.monotonic() - app["t_start"], 1),
        "tts_engine": app["tts_engine_mode"],
        "model": {"n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
                  "vocab": cfg.vocab_size},
    }
    if crashed:
        body["continuous_error"] = str(cont._crashed)
    return json_response(body, status=503 if crashed else 200)


def handle_metrics(request: Request) -> Response:
    app = request.app
    with app["metrics_lock"]:
        m = dict(app["metrics"])
    m.update({f"batcher_{k}": v for k, v in app["batcher"].stats.items()})
    cont = app["runtime"]["continuous"]
    if cont is not None:
        with cont._lock:
            m["continuous_live_slots"] = len(cont._live)
        m["continuous_slots"] = cont.B
        m["continuous_blocks"] = cont._block_seq
        m["continuous_crashed"] = int(cont._crashed is not None)
        m.update({f"continuous_loop_{k}": round(v, 4)
                  if isinstance(v, float) else v
                  for k, v in cont.stats.items()})
    store = app["voice_store"]
    if store is not None:   # a pipeline without a voice store is supported
        m.update({f"voice_cache_{k}": v for k, v in store.stats().items()})
    lines = [f"rwkv_tts_{k} {v}" for k, v in sorted(m.items())]
    lines += app["hist_latency"].render()
    lines += app["hist_rtf"].render()
    lines += app["hist_first_chunk"].render()
    if cont is not None:
        # the per-request serving stages the continuous engine records
        for h in cont.hist.values():
            lines += h.render()
    return Response(200, ("\n".join(lines) + "\n").encode(),
                    "text/plain; charset=utf-8")


def _static(path: str) -> Optional[str]:
    """The file under ``STATIC_DIR`` that ``path`` names, if there is one
    (``/`` is ``index.html``)."""
    rel = urllib.parse.unquote(path).lstrip("/") or "index.html"
    full = os.path.normpath(os.path.join(STATIC_DIR, rel))
    if full.startswith(STATIC_DIR + os.sep) and os.path.isfile(full):
        return full
    return None


ROUTES: Dict[tuple, Callable[[Request], Response]] = {
    ("POST", "/api/tts"): handle_tts,
    ("POST", "/api/tts/stream"): handle_tts_stream,
    ("POST", "/api/voice-clone/extract"): handle_voice_extract,
    ("GET", "/api/voice-clone/list"): handle_voice_list,
    ("POST", "/api/voice-clone/delete"): handle_voice_delete,
    ("GET", "/healthz"): handle_healthz,
    ("GET", "/metrics"): handle_metrics,
    ("POST", "/debug/trace"): handle_trace,
}


def _cors(resp: Response) -> Response:
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
    resp.headers["Access-Control-Allow-Headers"] = "Content-Type"
    return resp


# --------------------------------------------------------------------------
# the app and its socket layer
# --------------------------------------------------------------------------

class App(dict):
    """The server's state, under the JAX app's keys (``pipeline``,
    ``batcher``, ``runtime`` …), and its request dispatch."""

    def handle(self, method: str, path: str, headers, body: bytes
               ) -> Response:
        """Route one request; every response carries the CORS headers.
        Off the API routes this answers as the JAX app's aiohttp router
        does: its static route takes GET and HEAD on every path (a missing
        file is a 404 with no body), and any other method there is a 405
        naming what the path allows."""
        if method == "OPTIONS":
            return _cors(Response())
        lookup = "GET" if method == "HEAD" else method
        handler = ROUTES.get((lookup, path))
        if handler is None:
            if lookup == "GET":
                file = _static(path)
                if file is None:
                    return _cors(Response(404))
                with open(file, "rb") as f:
                    ctype = mimetypes.guess_type(file)[0] or \
                        "application/octet-stream"
                    if ctype.startswith("text/"):
                        ctype += "; charset=utf-8"
                    return _cors(Response(200, f.read(), ctype))
            allowed = {"GET", "HEAD"} | {m for m, p in ROUTES if p == path}
            return _cors(_text(405, "Method Not Allowed",
                               Allow=",".join(sorted(allowed))))
        try:
            resp = handler(Request(self, method, path, headers, body))
        except Exception:  # noqa: BLE001: the request's boundary
            log.exception("%s %s failed", method, path)
            resp = _text(500, "Internal Server Error")
        return _cors(resp)

    def close(self) -> None:
        """What the JAX app's ``on_cleanup`` does: end the requests in
        flight on the continuous engine (cancelled, their handlers left to
        finish, for up to 30 s), close the batcher (failing what it still
        queues), stop the decode loop."""
        rt = self["runtime"]
        with rt["flights_lock"]:
            flights = list(rt["flights"])
        for fl in flights:
            fl.abandon()
        deadline = time.monotonic() + 30.0
        for fl in flights:
            fl.ended.wait(max(0.0, deadline - time.monotonic()))
        self["batcher"].close()
        if rt["continuous"] is not None:
            rt["continuous"].stop()


def create_app(pipeline: TtsPipeline, batch_cfg: BatchConfig = BatchConfig(),
               stream_block: int = 16,
               tts_engine: str = "continuous") -> App:
    """``tts_engine``: which engine serves non-streaming /api/tts —
    ``"continuous"`` (the default: one slot of the decode loop the streams
    share) or ``"static"`` (``DynamicBatcher`` → ``synthesize_batch``).
    Serve it with ``make_server``; ``App.close`` releases it."""
    if tts_engine not in ("continuous", "static"):
        raise ValueError(f"tts_engine must be continuous|static, "
                         f"got {tts_engine!r}")
    app = App()
    app["pipeline"] = pipeline
    app["stream_block"] = int(stream_block)
    app["tts_engine_mode"] = tts_engine
    app["batch_cfg"] = batch_cfg
    app["voice_store"] = pipeline.voice_store
    app["batcher"] = DynamicBatcher(pipeline, batch_cfg)
    app["hist_latency"] = Histogram(
        "rwkv_tts_request_seconds", LATENCY_BUCKETS,
        "End-to-end /api/tts wall time")
    app["hist_rtf"] = Histogram(
        "rwkv_tts_rtf", RTF_BUCKETS,
        "Per-request real-time factor (synthesis wall / audio seconds)")
    app["hist_first_chunk"] = Histogram(
        "rwkv_tts_stage_first_chunk_seconds", STAGE_BUCKETS,
        "Stream request start to first audio chunk written (incl. vocode)")
    app["metrics"] = {"tts_requests": 0, "tts_audio_seconds": 0.0,
                      "voices_extracted": 0}
    app["metrics_lock"] = threading.Lock()
    app["t_start"] = time.monotonic()
    app["runtime"] = {"continuous": None, "lock": threading.Lock(),
                      "flights": set(), "flights_lock": threading.Lock(),
                      "trace_lock": threading.Lock()}
    return app


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "rwkv-tts-torch"
    timeout = 300                    # an idle keep-alive connection's life

    def _serve(self) -> None:
        t0 = time.perf_counter()
        path = urllib.parse.urlsplit(self.path).path
        body = self._read_body()
        if body is None:
            return
        resp = self.server.app.handle(self.command, path, self.headers, body)
        self._send(resp)
        log.info("%s %s -> %s (%.1f ms)", self.command, path, resp.status,
                 (time.perf_counter() - t0) * 1000)

    do_GET = do_POST = do_HEAD = do_OPTIONS = do_PUT = do_DELETE = \
        do_PATCH = _serve

    def _read_body(self) -> Optional[bytes]:
        """The request body (Content-Length or chunked), or None after a
        413 / 400 answer for a body over ``MAX_BODY`` or a malformed one."""
        try:
            if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
                parts, total = [], 0
                while True:
                    size = int(self.rfile.readline(65537).split(b";")[0], 16)
                    if size == 0:
                        end = (b"\r\n", b"\n", b"")
                        while self.rfile.readline(65537) not in end:
                            pass                    # trailer fields
                        return b"".join(parts)
                    total += size
                    if total > MAX_BODY:
                        break
                    parts.append(self.rfile.read(size))
                    self.rfile.readline()
            else:
                n = int(self.headers.get("Content-Length") or 0)
                if n < 0:
                    raise ValueError("negative Content-Length")
                if n <= MAX_BODY:
                    return self.rfile.read(n)
        except ValueError:
            self.close_connection = True
            self._send(_cors(_err("malformed request body", status=400)))
            return None
        self.close_connection = True
        self._send(_cors(_err(f"request body over {MAX_BODY} bytes",
                              status=413)))
        return None

    def _send(self, resp: Response) -> None:
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        for k, v in resp.headers.items():
            self.send_header(k, v)
        try:
            if resp.chunks is None:
                self.send_header("Content-Length", str(len(resp.body)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(resp.body)
                return
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for piece in resp.chunks:
                self.wfile.write(b"%x\r\n%s\r\n" % (len(piece), piece))
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except OSError:
            # a reset or closed socket mid-write: the client went away,
            # ordinary traffic and not an error of the server
            log.info("client disconnected mid-write")
            self.close_connection = True
        finally:
            if resp.chunks is not None:
                resp.chunks.close()

    def log_message(self, format, *args):  # noqa: A002: the base's name
        log.debug("%s " + format, self.address_string(), *args)


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address, app: App):
        self.app = app
        super().__init__(address, _Handler)

    def server_bind(self):
        # HTTPServer.server_bind asks for the host's fully qualified name
        # (a resolver lookup); the name is only used in CGI variables
        socketserver.TCPServer.server_bind(self)
        self.server_name, self.server_port = self.server_address[:2]

    def handle_error(self, request, client_address):
        """A connection its client reset or closed while the handler read
        from it (the next request on a keep-alive connection after an
        abandoned stream) is ordinary traffic, as a failed write is in
        ``_Handler._send``: logged, not printed as a traceback. Any other
        error gets the base class's report."""
        if isinstance(sys.exc_info()[1], (ConnectionResetError,
                                          ConnectionAbortedError,
                                          BrokenPipeError)):
            log.info("client %s disconnected", client_address)
            return
        super().handle_error(request, client_address)


def make_server(app: App, host: str = "127.0.0.1", port: int = 0
                ) -> http.server.ThreadingHTTPServer:
    """A bound server for ``app`` (port 0: any free port, read it from
    ``server_address``); run it with ``serve_forever``, end it with
    ``shutdown`` and ``server_close``, then ``app.close()``."""
    return _Server((host, port), app)


# --------------------------------------------------------------------------
# pipelines and the entry point
# --------------------------------------------------------------------------

def device_from_env() -> str:
    """``RWKV_TTS_PLATFORM=cpu`` (the JAX app's knob) selects the CPU;
    unset (or ``cuda``) means the card, and raises when there is none."""
    import torch

    plat = os.environ.get("RWKV_TTS_PLATFORM", "").strip().lower()
    if plat == "cpu":
        return "cpu"
    if plat not in ("", "cuda"):
        raise ValueError(f"RWKV_TTS_PLATFORM={plat!r}: expected cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; set RWKV_TTS_PLATFORM=cpu to run "
            "on the CPU (device='cpu')")
    return "cuda"


def build_dev_pipeline(raf_dir: str = "assets/raf",
                       engine_cfg: EngineConfig = EngineConfig(),
                       device=None, tp_mesh=None) -> TtsPipeline:
    """Random-weight pipeline at the JAX package's dev widths, drawn from
    one ``torch.Generator`` seeded with 0 on ``device``; ``tp_mesh`` shards
    its LM (``TtsPipeline``)."""
    import torch

    from ..models import bicodec, rwkv7, wav2vec2
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    lm_cfg = RwkvConfig(n_layer=2, n_embd=256, head_size=64, dtype="float32",
                        param_dtype="float32")
    # feat_dim must equal the wav2vec2 hidden size: the codec's encoder
    # consumes those features at enrollment
    w2v_cfg = Wav2Vec2Config(num_layers=2, hidden_size=256, num_heads=4,
                             ffn_size=512, conv_dims=(64,) * 7)
    bc_cfg = BiCodecConfig.tiny(feat_dim=w2v_cfg.hidden_size)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return TtsPipeline(
        rwkv7.init_params(lm_cfg, gen, dev), lm_cfg,
        bicodec.init_params(bc_cfg, gen, dev), bc_cfg,
        wav2vec2.init_params(w2v_cfg, gen, dev), w2v_cfg,
        voice_store=VoiceStore(raf_dir), engine_cfg=engine_cfg,
        w2v_output_layers=(1, 2), device=dev, tp_mesh=tp_mesh)


def build_pipeline_from_args(args) -> TtsPipeline:
    """Startup model resolution from the server's flags
    (bin/server.rs:1306-1351), on the device ``RWKV_TTS_PLATFORM`` selects:
    an existing ``--model-path`` loads through
    ``TtsPipeline.from_checkpoints`` (``--quant-type``, ``--quant-layers``,
    ``--vocab-path``, ``--allow-random-codec``; the codecs from the same
    directory), and an unreadable one raises. Without a checkpoint on disk
    it serves random weights (dev mode). First, unless ``--no-download``,
    the five published model files missing from the checkpoint's directory
    are downloaded (``utils/download.ensure_models``, soft: a file that
    stays missing is logged), as the JAX server does. ``--tp`` k > 1
    builds a (data, model = k) mesh over the visible devices
    (``parallel/mesh.visible_devices``: every card) and exits when k does
    not divide them, as the JAX server does: one card alone cannot serve
    ``--tp 2``."""
    if not args.no_download:
        from ..utils.download import ensure_models
        ensure_models(os.path.dirname(args.model_path) or "assets/model")
    else:
        log.info("--no-download: skipping model verification/auto-download")
    engine_cfg = EngineConfig().with_token_chunk(args.token_chunk_size)
    device = device_from_env()
    tp_mesh = None
    if getattr(args, "tp", 1) > 1:
        from ..parallel import mesh as meshlib
        devs = meshlib.visible_devices(device)
        n = len(devs)
        if n % args.tp:
            raise SystemExit(
                f"--tp {args.tp} does not divide the {n} visible devices")
        tp_mesh = meshlib.make_mesh(n, model_parallel=args.tp, devices=devs)
        log.info("tensor parallelism: mesh (data=%d, model=%d)",
                 n // args.tp, args.tp)
    cached_default = bool(getattr(args, "cached_speaker", False))
    if os.path.exists(args.model_path):
        pipeline = TtsPipeline.from_checkpoints(
            args.model_path, raf_dir=args.raf_dir,
            quant_type=args.quant_type, quant_layers=args.quant_layers,
            vocab_path=args.vocab_path, engine_cfg=engine_cfg,
            allow_random_codec=args.allow_random_codec,
            cached_speaker_default=cached_default, device=device,
            tp_mesh=tp_mesh)
        log.info("loaded checkpoint %s", args.model_path)
        return pipeline
    log.warning("checkpoint %s not found — serving with random weights "
                "(dev mode)", args.model_path)
    pipeline = build_dev_pipeline(args.raf_dir, engine_cfg=engine_cfg,
                                  device=device, tp_mesh=tp_mesh)
    pipeline.cached_speaker_default = cached_default
    return pipeline


def parse_args(argv=None):
    p = argparse.ArgumentParser("rwkvtts_server (PyTorch/CUDA)")
    p.add_argument("--port", type=int, default=3000)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--model-path", default="assets/model/webrwkv.safetensors")
    p.add_argument("--vocab-path", default=None)
    p.add_argument("--raf-dir", default="assets/raf")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--batch-timeout", type=float, default=20.0,
                   help="collect window, ms")
    p.add_argument("--inference-timeout", type=float, default=120000.0)
    p.add_argument("--quant-type", choices=["none", "int8", "int4", "nf4", "sf4"], default="none")
    p.add_argument("--quant-layers", type=int, default=-1,
                   help="quantize the first N blocks only, matching the "
                        "reference (shared_runtime.rs:156-176); 0 disables "
                        "quantization, -1 (default) quantizes every block")
    p.add_argument("--token-chunk-size", type=int, default=256)
    p.add_argument("--stream-block", type=int, default=16,
                   help="continuous-engine decode-block size; streaming "
                        "chunks are delivered per block, so 8 pairs with "
                        "latency_mode=flash (12-token first sound)")
    p.add_argument("--no-download", action="store_true",
                   help="skip the HF model auto-download check")
    p.add_argument("--allow-random-codec", action="store_true",
                   help="serve with random codec weights when the real "
                        "BiCodec/wav2vec2 files are missing (dev only: "
                        "output is noise, not speech)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree over the visible devices "
                        "(layer weights shard 1/tp per device); must "
                        "divide their count")
    p.add_argument("--warmup", action="store_true",
                   help="run every serving shape once before accepting "
                        "traffic")
    p.add_argument("--warmup-budget", type=float, default=None,
                   metavar="SECONDS",
                   help="wall-clock cap for --warmup (default: unbounded); "
                        "steps past it are skipped and warm on first use")
    p.add_argument("--tts-engine", choices=["continuous", "static"],
                   default="continuous",
                   help="engine behind non-streaming /api/tts: "
                        "'continuous' (default) shares the slot-based "
                        "decode loop with /api/tts/stream; 'static' sends "
                        "it through the DynamicBatcher to synthesize_batch")
    p.add_argument("--cached-speaker", action="store_true",
                   help="serve property-controlled requests through the "
                        "cached-speaker path by default (32 speaker tokens "
                        "cached per (properties, seed)); a request's "
                        "'cached_speaker' overrides it")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    log.info("initializing models …")
    pipeline = build_pipeline_from_args(args)
    log.info("models ready on %s; building app", pipeline.device)
    batch_cfg = BatchConfig(
        max_batch_size=args.batch_size,
        collect_timeout_ms=args.batch_timeout,
        inference_timeout_ms=args.inference_timeout,
    )
    app = create_app(pipeline, batch_cfg, stream_block=args.stream_block,
                     tts_engine=args.tts_engine)
    if args.tts_engine == "continuous":
        # the default serving engine: built at startup, not by the first
        # request
        _get_continuous(app)
    if args.warmup:
        log.info("warming up the serving shapes …")
        t_w = time.perf_counter()
        times = pipeline.warmup(budget_s=args.warmup_budget)
        log.info("pipeline warmup done in %.1fs: %s",
                 time.perf_counter() - t_w, times)
        if args.warmup_budget is None or \
                time.perf_counter() - t_w < args.warmup_budget:
            _get_continuous(app).warmup()
            log.info("continuous-engine warmup done (total %.1fs)",
                     time.perf_counter() - t_w)
        else:
            log.warning("warmup budget exhausted before the continuous-"
                        "engine warmup; its shapes warm on first use")
    server = make_server(app, args.host, args.port)
    log.info("serving on http://%s:%d", *server.server_address[:2])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        app.close()


if __name__ == "__main__":
    main()

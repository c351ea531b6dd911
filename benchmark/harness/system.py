"""The system under test: ``rwkv_tts_tpu_torch``'s continuous engine and
pipeline, driven in process as the server's handlers drive them.

This is the one module of the benchmark that imports the program. A
backlog request runs as ``/api/tts`` runs it on the continuous engine
(``ContinuousEngine.submit``, then ``TtsPipeline.vocode``); a streamed one
as ``/api/tts/stream`` does (``runtime/streaming.stream_synthesize`` over
the same engine, the pipeline's ``decode_graphs`` for the windows).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .traffic import Stopped, now


class System:
    def __init__(self, config: dict, mix: dict, lm_raw: dict, codec: dict,
                 device, control: Optional[dict] = None):
        """``control``: the configuration's control layouts (its LM
        ``quant`` and ``codec_dtype``) in place of its own."""
        from rwkv_tts_tpu_torch.config import (BiCodecConfig, EngineConfig,
                                               RwkvConfig)
        from rwkv_tts_tpu_torch.ops.quant import quantize_rwkv_params
        from rwkv_tts_tpu_torch.runtime.continuous import ContinuousEngine
        from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline

        self.device = torch.device(device)
        self.lm_cfg = RwkvConfig(**_tuples(config["lm"]))
        self.codec_cfg = BiCodecConfig(**_tuples(config["codec"]))
        quant = (control or config)["quant"]
        params = (quantize_rwkv_params(lm_raw, kind=quant) if quant
                  else lm_raw)
        slots = mix["slots"]
        ecfg = EngineConfig(batch_size=slots)
        self.pipe = TtsPipeline(params, self.lm_cfg, codec, self.codec_cfg,
                                engine_cfg=ecfg, device=self.device,
                                codec_dtype=(control or {}).get("codec_dtype"))
        self.codec_cfg = self.pipe.bicodec_cfg
        self.engine = ContinuousEngine(
            params, self.lm_cfg, ecfg, tokenizer=self.pipe.engine.tokenizer,
            block=mix["block"], slots=slots, device=self.device)
        self.mix = mix
        self._flight: Dict[int, object] = {}
        self._flight_lock = threading.Lock()
        self.spans: List[tuple] = []       # (kind, t0, t1, n) host spans
        self._spans_lock = threading.Lock()
        # closed while the profiler starts or stops (``quiet``): a backlog
        # request waits there before it vocodes
        self._vocode_gate = threading.Event()
        self._vocode_gate.set()
        self._vocoding = 0
        self._vocoding_cv = threading.Condition()

    # -- set-up ---------------------------------------------------------

    def prompt_len(self, req: dict) -> int:
        return len(self.engine.inner.build_prompt(self._args(req))[0])

    def warm(self, vocode_latents: List[int], windows: bool):
        """The admission bursts of every power of two up to the slot count
        at the first prefill bucket, every decode bucket, then the
        vocoder's programs this mix reaches: the detokenize buckets of
        ``vocode_latents``, or the streaming windows of its latency
        mode."""
        self.engine.warmup(max_burst=self.engine.B, prefill_buckets=1)
        from rwkv_tts_tpu_torch.models import bicodec
        from rwkv_tts_tpu_torch.runtime.streaming import StreamingVocoder
        codec, cfg = self.pipe.bicodec_params, self.codec_cfg
        if windows:
            sv = StreamingVocoder(codec, cfg, [0] * 32,
                                  latency_mode=self.mix["latency_mode"])
            for W in sorted({sv.window_bucket, sv.flush_bucket}):
                bicodec.decode_host(codec, [[0] * 32], [[0] * W], cfg,
                                    self.pipe.decode_graphs)
        for S in vocode_latents:
            bicodec.detokenize(codec, [0] * 32, [0] * S, cfg,
                               graphs=self.pipe.decode_graphs)
        self.sync()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- requests -------------------------------------------------------

    def _args(self, req: dict):
        from rwkv_tts_tpu_torch.config import TtsArgs
        return TtsArgs(text=req["text"], max_tokens=req["max_tokens"],
                       seed=req["seed"], age=req["age"],
                       gender=req["gender"], emotion=req["emotion"],
                       pitch=req["pitch"], speed=req["speed"])

    def _generate(self, args):
        """Submit and wait; the request counts as in flight meanwhile."""
        from rwkv_tts_tpu_torch.runtime.continuous import RequestCancelled
        done, box = threading.Event(), []

        def cb(res):
            box.append(res)
            done.set()

        with self._flight_lock:
            self._flight[id(args)] = args
        try:
            self.engine.submit(args, cb)
            done.wait()
        finally:
            with self._flight_lock:
                self._flight.pop(id(args), None)
        if isinstance(box[0], RequestCancelled):
            raise Stopped()
        if isinstance(box[0], Exception):
            raise box[0]
        return box[0]

    def serve_backlog(self, req: dict, rec: dict):
        """One ``/api/tts`` request: tokens, then the whole utterance
        vocoded on this thread."""
        rec["failed"] = False
        try:
            gen = self._generate(self.pipe.resolve_voice(self._args(req)))
        except Stopped:
            raise
        except Exception as e:  # noqa: BLE001: a failed request is counted
            rec.update(failed=True, error=repr(e), t_done=now())
            return
        self._vocode_gate.wait()
        with self._vocoding_cv:
            self._vocoding += 1
        try:
            t0 = now()
            wav = self.pipe.vocode(gen)
            t1 = now()
        finally:
            with self._vocoding_cv:
                self._vocoding -= 1
                self._vocoding_cv.notify_all()
        self._span("vocode", t0, t1, len(gen.semantic_tokens))
        rec.update(globals=list(gen.global_tokens),
                   semantic=list(gen.semantic_tokens), audio=wav,
                   audio_s=len(wav) / 16000.0, t_gen=t0, t_done=t1)

    def serve_stream(self, req: dict, rec: dict):
        """One ``/api/tts/stream`` request: chunks as they come, each with
        the benchmark's clock."""
        from rwkv_tts_tpu_torch.runtime.continuous import RequestCancelled
        from rwkv_tts_tpu_torch.runtime.streaming import stream_synthesize
        args = self.pipe.resolve_voice(self._args(req))
        box = {}
        proxy = _Capture(self.engine, box)
        rec.update(failed=False, chunks=[], audio_parts=[])
        with self._flight_lock:
            self._flight[id(args)] = args
        try:
            for ch in stream_synthesize(
                    proxy, self.pipe.bicodec_params, self.codec_cfg, args,
                    latency_mode=self.mix["latency_mode"],
                    vocoder_graphs=self.pipe.decode_graphs):
                rec["chunks"].append((now(), len(ch.audio)))
                rec["audio_parts"].append(ch.audio)
                if ch.final:
                    break
        except RequestCancelled:
            raise Stopped()
        except Exception as e:  # noqa: BLE001: a failed request is counted
            rec.update(failed=True, error=repr(e))
            return
        finally:
            with self._flight_lock:
                self._flight.pop(id(args), None)
        res = box.get("res")
        audio = (np.concatenate(rec.pop("audio_parts"))
                 if rec["chunks"] else np.zeros(0, np.float32))
        rec.update(globals=list(res.global_tokens),
                   semantic=list(res.semantic_tokens), audio=audio,
                   audio_s=len(audio) / 16000.0, t_done=now())

    def cancel_all(self):
        with self._flight_lock:
            flight = list(self._flight.values())
        for args in flight:
            self.engine.cancel(args)

    # -- what the per-layer readers take from the program ----------------

    def blocks(self) -> int:
        return self.engine._block_seq

    def live(self) -> int:
        return len(self.engine._live)

    def _span(self, kind, t0, t1, n=0):
        with self._spans_lock:
            self.spans.append((kind, t0, t1, n))

    def instrument(self):
        """Host spans around the decode loop's admission, block dispatch
        (with its occupancy bucket) and readback, for the traced run."""
        eng = self.engine
        for name, kind in (("_admit", "admission"),
                           ("_process_block", "readback")):
            fn = getattr(eng, name)
            setattr(eng, name, self._wrapped(fn, kind))
        decode = eng._decode

        def _decode(bucket):
            t0 = now()
            out = decode(bucket)
            self._span("dispatch", t0, now(), bucket)
            return out

        eng._decode = _decode

    def _wrapped(self, fn, kind):
        def call(*a, **k):
            t0 = now()
            try:
                return fn(*a, **k)
            finally:
                self._span(kind, t0, now())
        return call

    @contextlib.contextmanager
    def quiet(self):
        """No thread of the system launches work on the card inside: the
        decode loop is stopped (after its block in flight, as
        ``ContinuousEngine.stop`` does) and no vocoder call runs (backlog
        requests wait at a gate, stream windows for the vocoder's turn),
        then both resume. CUPTI's start and stop deadlock with a graph
        launched from another thread at that moment; the requests in
        flight only wait."""
        self._vocode_gate.clear()
        # the backlog's vocodes in flight finish first (they need the
        # vocoder's turn), then the turn is held against stream windows
        with self._vocoding_cv:
            self._vocoding_cv.wait_for(lambda: self._vocoding == 0)
        graphs = self.pipe.decode_graphs
        turn = graphs.cache._turn if graphs is not None else threading.Lock()
        turn.acquire()
        try:
            self.engine.stop(timeout=60.0)
            self.sync()
            yield
        finally:
            self.engine.start()
            turn.release()
            self._vocode_gate.set()

    def close(self):
        self.engine.stop(timeout=30.0)
        self.sync()


class _Capture:
    """The engine as ``stream_synthesize`` sees it, with the request's
    result also kept for the benchmark's check."""

    def __init__(self, engine, box):
        self._engine, self._box = engine, box

    def submit(self, args, result_cb, chunk_cb=None):
        def cb(res):
            self._box["res"] = res
            result_cb(res)
        self._engine.submit(args, cb, chunk_cb=chunk_cb)

    def __getattr__(self, name):
        return getattr(self._engine, name)


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

"""Streaming synthesis: incremental BiCodec vocoding over a growing semantic
prefix.

Port of ``rwkv_tts_tpu/runtime/streaming.py``:

  * the continuous engine delivers semantic tokens in blocks as they decode;
  * every ``chunk_tokens`` new tokens a window of ``context + new +
    lookahead`` latents is vocoded and only the new samples are emitted.
    Context and lookahead default to the decoder's receptive field
    (``models/bicodec.receptive_latents``), so the emitted audio is that of
    a full bucketed decode at those offsets (tested);
  * windows are padded to one of two fixed lengths (interior and flush), so
    the vocoder sees two shapes per latency mode.

First audio therefore needs the prefill, ``chunk + lookahead`` decode steps
and one vocoder window, whatever the utterance's length.

The vocoder runs in the thread that consumes the stream, on that thread's
current CUDA stream; the engine's decode thread decodes on a stream of its
own (``runtime/continuous``). Only Python lists of tokens cross between
them. The vocoder is the native BiCodec or the reference's exported
graphs (``bicodec.OnnxBiCodec``). Given the native tree's
``bicodec.DecodeGraphs`` (the pipeline's ``decode_graphs`` on a card), a
window replays the CUDA graph of its length, shared by every stream's
thread one turn at a time: the counterpart of the JAX package's jitted
``bicodec.decode``. Without it, and for the ONNX graphs, windows run
eagerly.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterator, List, Optional

import numpy as np

from .. import constants as C
from ..config import BiCodecConfig
from ..models import bicodec
from ..utils import trace


@dataclasses.dataclass
class StreamChunk:
    seq: int
    audio: np.ndarray        # f32 samples @16 kHz (possibly empty)
    final: bool


class StreamingVocoder:
    """Incremental tokens → audio for one utterance."""

    # (context, lookahead, largest first chunk) per latency mode; "exact"
    # uses the decoder's receptive field for both. "flash" emits its first
    # sound after chunk + lookahead = 12 semantic steps (160 ms of audio
    # per chunk). The short windows still cover the wave generator's own
    # receptive field; what they cut is the prenet's long conditioning
    # tail, so they are close to the full decode, not equal to it.
    LATENCY_PRESETS = {"low": (32, 16, 32), "ultra": (16, 8, 16),
                       "flash": (16, 4, 8)}

    def __init__(self, params, cfg: BiCodecConfig, global_tokens: List[int],
                 chunk_tokens: int = 32, context_tokens: Optional[int] = None,
                 lookahead_tokens: Optional[int] = None,
                 low_latency: bool = False,
                 latency_mode: Optional[str] = None,
                 graphs: Optional[bicodec.DecodeGraphs] = None):
        self.params = params
        self.cfg = cfg
        self.graphs = graphs
        self.global_tokens = [min(max(int(t), 0), C.GLOBAL_VOCAB - 1)
                              for t in (global_tokens or [0] * 32)]
        if latency_mode is None:
            latency_mode = "low" if low_latency else "exact"
        if latency_mode != "exact" and \
                latency_mode not in self.LATENCY_PRESETS:
            raise ValueError(f"unknown latency_mode {latency_mode!r}")
        self.receptive = bicodec.receptive_latents(cfg)
        if latency_mode in self.LATENCY_PRESETS:
            ctx_d, la_d, ck_d = self.LATENCY_PRESETS[latency_mode]
            chunk_tokens = min(chunk_tokens, ck_d)
            if context_tokens is None:
                context_tokens = min(ctx_d, self.receptive)
            if lookahead_tokens is None:
                lookahead_tokens = min(la_d, self.receptive)
        self.chunk = chunk_tokens
        self.context = (context_tokens if context_tokens is not None
                        else self.receptive)
        # the vocoder's convs are centred, so output near a chunk's right
        # edge depends on future latents: hold back ``lookahead`` tokens
        # until their right context exists
        self.lookahead = (lookahead_tokens if lookahead_tokens is not None
                          else self.receptive)
        self.window_bucket = self.context + chunk_tokens + self.lookahead
        # a flush window carries up to chunk + lookahead − 1 leftover tokens
        # plus the receptive-field edge padding: always this one multiple of
        # the bucket, so streaming runs exactly two vocoder shapes
        worst_flush = (self.context + self.chunk + self.lookahead - 1
                       + self.receptive)
        self.flush_bucket = (-(-worst_flush // self.window_bucket)
                             * self.window_bucket)
        self._tokens: List[int] = []
        self._emitted = 0        # tokens already vocoded and emitted

    def push(self, new_tokens: List[int], flush: bool = False) -> np.ndarray:
        """Add tokens; returns the newly available samples (maybe none).
        ``flush`` vocodes whatever remains (end of stream)."""
        self._tokens.extend(int(t) for t in new_tokens)
        out = []
        while len(self._tokens) - self._emitted >= self.chunk + self.lookahead:
            out.append(self._vocode_next(self.chunk, flush=False))
        if flush and len(self._tokens) > self._emitted:
            out.append(self._vocode_next(len(self._tokens) - self._emitted,
                                         flush=True))
        if not out:
            return np.zeros(0, np.float32)
        return np.concatenate(out)

    def _vocode_next(self, n_emit: int, flush: bool) -> np.ndarray:
        """One window; while the recorder is on, its ``window`` span (n =
        the padded latents: the flush or the interior bucket) under the
        request the thread has bound."""
        padded = self.flush_bucket if flush else self.window_bucket
        with trace.scope("window", n=padded) if trace.on else trace.OFF:
            return self._window(n_emit, flush, padded)

    def _window(self, n_emit: int, flush: bool, padded: int) -> np.ndarray:
        end = self._emitted + n_emit + (0 if flush else self.lookahead)
        start = max(0, self._emitted - self.context)
        ctx = self._emitted - start
        window = self._tokens[start:end]
        # a final chunk is edge-padded by at least the receptive field, the
        # padding ``detokenize`` applies past the utterance's end, so the
        # tail matches the full decode; an interior chunk's real lookahead
        # covers the emitted region and the filler beyond it is not heard
        # (``padded``). Checked on the host; with graphs, the window
        # length's program
        wav = bicodec.decode_host(
            self.params, [self.global_tokens],
            [window + [window[-1]] * (padded - len(window))], self.cfg,
            self.graphs)
        hop = C.LATENT_HOP_LENGTH
        t0 = trace.now() if trace.on else 0
        audio = wav[0, ctx * hop:(ctx + n_emit) * hop].cpu().numpy().astype(
            np.float32)
        if t0:
            trace.child("vocode.readback", t0, n=n_emit)
        self._emitted += n_emit
        return audio


def stream_synthesize(continuous_engine, bicodec_params, bicodec_cfg,
                      args, chunk_tokens: int = 32, timeout: float = 600.0,
                      low_latency: bool = False,
                      latency_mode: Optional[str] = None,
                      vocoder_graphs: Optional[bicodec.DecodeGraphs] = None
                      ) -> Iterator[StreamChunk]:
    """Generator yielding audio chunks for one request, which must already
    be resolved (``TtsPipeline.resolve_voice``). ``vocoder_graphs``: the
    codec tree's ``bicodec.DecodeGraphs`` (``TtsPipeline.decode_graphs``),
    replayed for every window; None vocodes eagerly.

    A property-controlled request's speaker tokens exist only once its
    global stage ends, so vocoding starts at the first semantic chunk; a
    zero-shot request vocodes from its first block.

    While the recorder (``utils/trace``) is on, the windows are vocoded
    under the trace id ``submit`` returned, and each chunk is marked
    (``chunk``, n = samples) as it is yielded."""
    q: "queue.Queue" = queue.Queue()
    done = threading.Event()
    box = {}

    def chunk_cb(req, toks):
        q.put(list(toks))

    def result_cb(res):
        box["res"] = res
        done.set()
        q.put(None)

    # an engine wrapper that drops ``submit``'s return leaves the id 0
    tid = continuous_engine.submit(args, result_cb, chunk_cb=chunk_cb) or 0

    def push(tokens, flush=False) -> np.ndarray:
        with trace.request(tid) if trace.on else trace.OFF:
            return vocoder.push(tokens, flush=flush)

    def chunk(audio, final) -> StreamChunk:
        if trace.on:
            trace.mark("chunk", trace.now(), req=tid, n=len(audio))
        return StreamChunk(seq=seq, audio=audio, final=final)

    def vocoder_for(global_tokens):
        return StreamingVocoder(bicodec_params, bicodec_cfg, global_tokens,
                                chunk_tokens, low_latency=low_latency,
                                latency_mode=latency_mode,
                                graphs=vocoder_graphs)

    vocoder: Optional[StreamingVocoder] = None
    seq = 0
    deadline = time.monotonic() + timeout
    while True:
        try:
            item = q.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            raise TimeoutError("streaming synthesis timed out")
        if item is None:
            res = box["res"]
            if isinstance(res, Exception):
                # the engine failed or cancelled this request: a flushed
                # partial chunk marked final would report truncated audio
                # as a clean end
                raise res
            if vocoder is None:
                vocoder = vocoder_for(res.global_tokens)
            yield chunk(push([], flush=True), True)
            return
        if vocoder is None:
            # the global tokens are final once semantic tokens arrive
            vocoder = vocoder_for(_resolve_globals(continuous_engine, args,
                                                   box, done))
        audio = push(item)
        if audio.size:
            yield chunk(audio, False)
            seq += 1


def _resolve_globals(engine, args, box, done) -> List[int]:
    """Speaker tokens for the vocoder, in trust order: the live slot, the
    finished result, the request's own reference tokens. A short request
    can retire (its result callback and slot pop run in the same block
    iteration as its chunk callback) before the consumer builds the
    vocoder; zeros there would vocode the whole utterance in a wrong
    voice."""
    with engine._lock:
        for live in engine._live.values():
            if live.request is args:
                return list(live.global_tokens)
    res = box.get("res")
    if res is None and done.wait(timeout=10.0):
        # the engine pops the slot before the result callback stores the
        # result: a consumer waking on the first chunk in that gap finds
        # neither, and the callback fires within the same block iteration
        res = box.get("res")
    if res is not None and not isinstance(res, Exception):
        return list(res.global_tokens)
    if args.ref_global_tokens:
        return list(args.ref_global_tokens)
    raise RuntimeError(
        "streaming: request is no longer live and no result is available "
        "to resolve its speaker tokens")

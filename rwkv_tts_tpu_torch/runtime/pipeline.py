"""End-to-end TTS pipeline: text (+ a voice) → tokens → waveform.

Port of ``rwkv_tts_tpu/runtime/pipeline.TtsPipeline``: property-controlled
synthesis and zero-shot voice cloning. The voice chain resolves, in order,
an enrolled ``voice_id`` of the voice store, direct reference tokens, and a
reference audio file (wav2vec2 features + BiCodec encode, behind a
file-checksum cache), else property tokens (``pipeline.py:186-252``).
``from_checkpoints`` loads the LM checkpoint and resolves the codecs from
a model directory (``pipeline.py:88-180``); the codecs may be the
reference's exported graphs (``OnnxBiCodec``, ``OnnxWav2Vec2``), which
enrollment, vocoding and warmup take in place of parameter trees.
The chain's last opt-in rung is the cached speaker (``pipeline.py:234-273``):
a property-controlled request reuses 32 speaker tokens cached by
(properties, seed) and runs the zero-shot chain, skipping the global stage.
``synthesize_batch`` keeps the JAX pipeline's mode grouping, stage timings
and RTF accounting (``pipeline.py:309-349``); ``assemble_result`` packages
one continuous-engine generation the same way. ``enroll_voice`` extracts a
reference file's tokens into the voice store, ``save_audio`` writes WAV or
MP3, and ``warmup`` runs every serving shape once before traffic
(``pipeline.py:400-638``).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from ..audio import io as audio_io
from ..audio.frontend import load_and_process, zero_mean_unit_variance
from ..config import (BiCodecConfig, EngineConfig, RwkvConfig, TtsArgs,
                      Wav2Vec2Config)
from ..models import bicodec, rwkv7, wav2vec2
from ..utils import trace
from ..utils.device import resolve_device
from ..utils.rtf import StageTimer
from .engine import GenerationResult, TtsEngine
from .voice_store import VoiceStore

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SynthesisResult:
    audio: np.ndarray            # f32 waveform @16 kHz
    sample_rate: int
    global_tokens: List[int]
    semantic_tokens: List[int]
    timings_ms: Dict[str, float]
    rtf: float


class TtsPipeline:
    """Owns the LM engine, BiCodec, wav2vec2 and the voice store.
    Parameters are the port's tensor dicts, already on ``device``
    (``utils/bridge.py`` or the models' ``init_params``); without wav2vec2
    parameters a reference-audio request falls down the voice chain."""

    def __init__(self, lm_params, lm_cfg: RwkvConfig, bicodec_params,
                 bicodec_cfg: BiCodecConfig, w2v_params=None,
                 w2v_cfg: Optional[Wav2Vec2Config] = None,
                 voice_store: Optional[VoiceStore] = None,
                 engine_cfg: EngineConfig = EngineConfig(), tokenizer=None,
                 w2v_output_layers=wav2vec2.OUTPUT_LAYERS, device=None,
                 cached_speaker_default: bool = False,
                 codec_dtype: Optional[str] = None,
                 codec_conv_impl: Optional[str] = None, tp_mesh=None):
        """``tp_mesh``: tensor parallelism of the LM over a
        ``parallel/mesh.Mesh`` (``TtsEngine``'s argument); the codecs stay
        on ``device``. ``codec_dtype`` sets the BiCodec compute policy
        (``BiCodecConfig.dtype``) and casts the decode subtrees once, here;
        ``codec_conv_impl`` sets the wave generator's conv backend
        (``BiCodecConfig.conv_impl``), as the JAX pipeline's loader does
        (``pipeline.py:164-178``). Under a backend that routes to
        ``ops.conv1d`` the routed conv weights are packed here, once
        (``bicodec.pack_params``)."""
        self.device = resolve_device(device)
        if codec_conv_impl is not None:
            bicodec_cfg = dataclasses.replace(bicodec_cfg,
                                              conv_impl=codec_conv_impl)
        if codec_dtype is not None:
            bicodec_cfg = dataclasses.replace(bicodec_cfg, dtype=codec_dtype)
        if isinstance(bicodec_params, bicodec.OnnxBiCodec):
            # the exported graphs run as exported: float32, their own convs
            if codec_dtype is not None or codec_conv_impl is not None:
                log.warning("codec_dtype / codec_conv_impl apply to the "
                            "native BiCodec only; the ONNX graphs run as "
                            "exported")
        elif codec_dtype is not None:
            bicodec_params = bicodec.prepare_params(bicodec_params,
                                                    bicodec_cfg)
        else:
            bicodec_params = bicodec.pack_params(bicodec_params, bicodec_cfg)
        self.engine = TtsEngine(lm_params, lm_cfg, engine_cfg,
                                tokenizer=tokenizer,
                                device=None if tp_mesh else self.device,
                                tp_mesh=tp_mesh)
        self.bicodec_params = bicodec_params
        self.bicodec_cfg = bicodec_cfg
        # on a card the native codec's windows and detokenize buckets replay
        # CUDA graphs, held here for the pipeline's life; the ONNX graphs and
        # the CPU decode eagerly
        self.decode_graphs = (
            None if isinstance(bicodec_params, bicodec.OnnxBiCodec)
            else bicodec.decode_graphs(bicodec_params, bicodec_cfg))
        self.w2v_params = w2v_params
        self.w2v_cfg = w2v_cfg
        self.w2v_output_layers = w2v_output_layers
        self.voice_store = voice_store
        # reference-audio tokens by file checksum, least recently used out
        self._extract_cache = collections.OrderedDict()
        self._extract_cache_cap = 64
        self._extract_cache_lock = threading.Lock()
        # cached-speaker path: speaker tokens by (properties, seed); off
        # unless a request or this default asks for it
        self.cached_speaker_default = cached_speaker_default
        self._speaker_cache: Dict[tuple, List[int]] = {}
        self._speaker_cache_lock = threading.Lock()

    @classmethod
    def from_checkpoints(cls, model_path: str, raf_dir: str = "assets/raf",
                         dtype: str = "bfloat16", quant_type: str = "none",
                         quant_layers: int = -1, vocab_path: str = None,
                         codec_dir: Optional[str] = None,
                         allow_random_codec: bool = False, device=None,
                         fuse: bool = False, **kw) -> "TtsPipeline":
        """Load the serving stack from disk onto ``device``
        (``pipeline.py:88-180``).

        LM: ``model_path``, a webrwkv.safetensors file or a prefab, or a
        directory holding rwkvtts-Int8_22.safetensors (preferred) or
        webrwkv.safetensors (shared_runtime.rs:85-97). ``fuse`` fuses the
        projections (``rwkv7.fuse_params``); ``quant_type`` "int8", "int4"
        or "nf4" ("sf4" serves as nf4) quantizes the first ``quant_layers``
        blocks (-1: all). The codecs come from ``codec_dir`` (default: the
        LM's directory) through ``load_codecs``: a missing codec raises
        unless ``allow_random_codec``. ``codec_dtype``, ``codec_conv_impl``
        and ``tp_mesh`` in ``kw`` go to the constructor, which casts and
        packs once. Under a ``tp_mesh`` the raw layout is served: ``fuse``
        is off and a 4-bit ``quant_type`` serves int8, as in the JAX
        pipeline (``pipeline.py:121-134``). Each step's time is logged."""
        from ..models.codec_loader import load_codecs
        from ..models.convert import load_rwkv7
        from ..ops.quant import quantize_rwkv_params
        from ..tokenizer import load_tokenizer

        dev = resolve_device(device)
        if os.path.isdir(model_path):
            for cand in ("rwkvtts-Int8_22.safetensors",
                         "webrwkv.safetensors"):
                p = os.path.join(model_path, cand)
                if os.path.exists(p):
                    model_path = p
                    break
            else:
                raise FileNotFoundError(
                    f"No supported model file found in directory: "
                    f"{model_path} (looked for rwkvtts-Int8_22.safetensors, "
                    f"webrwkv.safetensors)")
        t0 = time.perf_counter()
        lm_params, lm_cfg = load_rwkv7(model_path, dtype=dtype, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log.info("LM %s: %d layers x %d read, mapped and on %s in %.2f s",
                 model_path, lm_cfg.n_layer, lm_cfg.n_embd, dev,
                 time.perf_counter() - t0)
        tp_mesh = kw.get("tp_mesh")
        if tp_mesh is not None:
            # tensor parallelism shards the raw layout; int8 shards too,
            # the 4-bit layouts do not
            if quant_type in ("int4", "nf4", "sf4"):
                log.warning("tp_mesh: %s layout is not TP-shardable — "
                            "serving int8 instead", quant_type)
                quant_type = "int8"
            log.info("tp_mesh set: raw %s layout, weights shard 1/%d "
                     "per device", quant_type, tp_mesh.mp)
        elif fuse:
            # opt-in projection fusion (7 projections → 2 matmuls): it
            # doubles the r/k/v and LoRA-A bytes, so the raw layout stays
            # the default, as in the JAX package
            lm_params = rwkv7.fuse_params(lm_params, lm_cfg)
        if vocab_path:
            kw.setdefault("tokenizer", load_tokenizer(vocab_path))
        if quant_type in ("int8", "int4", "nf4", "sf4"):
            # web-rwkv's SF4 is an internal float4 format; NF4 covers the
            # same 4-bit point (bin/server.rs:1203-1233)
            kind = "nf4" if quant_type == "sf4" else quant_type
            t0 = time.perf_counter()
            lm_params = quantize_rwkv_params(lm_params,
                                             quant_layers=quant_layers,
                                             kind=kind)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            log.info("LM quantized to %s (quant_layers %d) in %.2f s", kind,
                     quant_layers, time.perf_counter() - t0)
        codec_dir = codec_dir or (os.path.dirname(model_path) or ".")
        t0 = time.perf_counter()
        bc_params, bc_cfg, w2v_params, w2v_cfg, w2v_layers = load_codecs(
            codec_dir, allow_random=allow_random_codec, device=dev)
        log.info("codecs from %s resolved in %.2f s", codec_dir,
                 time.perf_counter() - t0)
        kw.setdefault("w2v_output_layers", w2v_layers)
        return cls(lm_params, lm_cfg, bc_params, bc_cfg, w2v_params, w2v_cfg,
                   voice_store=VoiceStore(raf_dir), device=dev, **kw)

    def resolve_voice(self, args: TtsArgs) -> TtsArgs:
        """The voice chain (lightweight_tts_pipeline.rs:747-787): an
        enrolled voice_id, direct reference tokens, a reference audio file,
        the cached speaker where asked for, else property tokens. Every
        cloning rung forces seed 0, as the reference does
        (dynamic_batch_manager.rs:435-441, 487-496); a rung that fails falls
        down the chain instead of failing the batch. The cached-speaker
        rung keeps the user's seed for the semantic stage, so different
        seeds still vary the delivery."""
        if args.voice_id and self.voice_store is not None:
            try:
                g, s, prompt = self.voice_store.get_voice_tokens(
                    args.voice_id)
            except (OSError, KeyError, TypeError, ValueError) as e:
                log.warning("voice_id %r failed to load (%s): falling back "
                            "down the voice chain", args.voice_id, e)
            else:
                return dataclasses.replace(
                    args, zero_shot=True, ref_global_tokens=g,
                    ref_semantic_tokens=s,
                    prompt_text=args.prompt_text or prompt, seed=0)
        elif args.voice_id:
            log.warning("voice_id %r ignored: no voice store configured",
                        args.voice_id)
        if args.ref_global_tokens:
            return dataclasses.replace(args, zero_shot=True, seed=0)
        if args.ref_audio_path:
            try:
                g, s, _ = self.extract_voice_tokens_cached(
                    args.ref_audio_path)
            except Exception as e:  # noqa: BLE001 — any bad file degrades
                # this request only, as in the JAX pipeline
                log.warning("ref_audio_path %r failed to extract (%s): "
                            "falling back down the voice chain",
                            args.ref_audio_path, e, exc_info=True)
            else:
                return dataclasses.replace(
                    args, zero_shot=True, ref_global_tokens=g,
                    ref_semantic_tokens=s, seed=0)
        use_cached = (args.cached_speaker if args.cached_speaker is not None
                      else self.cached_speaker_default)
        if use_cached:
            return dataclasses.replace(
                args, zero_shot=True,
                ref_global_tokens=self.get_cached_speaker(args),
                ref_semantic_tokens=[])
        return dataclasses.replace(args, zero_shot=False)

    def get_cached_speaker(self, args: TtsArgs) -> List[int]:
        """Speaker tokens for (properties, seed), generated once and
        cached. ``seed=None`` is its own key: one default voice for the
        pipeline's lifetime, drawn once from OS entropy."""
        key = (args.age, args.gender, args.emotion, args.pitch, args.speed,
               args.seed)
        with self._speaker_cache_lock:
            hit = self._speaker_cache.get(key)
        if hit is not None:
            return list(hit)
        seed = (int(args.seed) if args.seed is not None
                else int.from_bytes(os.urandom(4), "little"))
        toks = self.engine.generate_speaker_tokens(args, seed)
        with self._speaker_cache_lock:
            # a concurrent miss may have raced this one: the first writer
            # wins, so every request with this key gets one speaker
            hit = self._speaker_cache.setdefault(key, toks)
        return list(hit)

    def extract_voice_tokens(self, audio_path: str):
        """Reference audio file → (global tokens, semantic tokens,
        duration s): the front end on the host, then wav2vec2 features and
        BiCodec encode on the pipeline's device
        (bin/server.rs:195-276, ref_audio_utilities.rs:1047-1257)."""
        if self.w2v_params is None:
            raise RuntimeError("wav2vec2 weights not loaded")
        pa = load_and_process(audio_path)
        z = zero_mean_unit_variance(pa.wav)
        if isinstance(self.w2v_params, wav2vec2.OnnxWav2Vec2):
            feat = self.w2v_params.extract(z[None, :])
        else:
            feat = wav2vec2.extract_features(
                self.w2v_params, z[None, :], self.w2v_cfg,
                output_layers=self.w2v_output_layers, device=self.device)
        if isinstance(self.bicodec_params, bicodec.OnnxBiCodec):
            sem, glob = self.bicodec_params.encode(feat, pa.ref_mel[None])
        else:
            sem, glob = bicodec.encode(self.bicodec_params, feat,
                                       pa.ref_mel[None], self.bicodec_cfg,
                                       device=self.device)
        return ([int(x) for x in glob[0].tolist()],
                [int(x) for x in sem[0].tolist()], pa.duration)

    def extract_voice_tokens_cached(self, audio_path: str):
        """``extract_voice_tokens`` behind a checksum cache of the file's
        bytes, so a reference file reused across requests is encoded once
        (an in-memory LRU; voice enrollment is the durable form)."""
        with open(audio_path, "rb") as f:
            key = hashlib.sha256(f.read()).hexdigest()
        with self._extract_cache_lock:
            if key in self._extract_cache:
                self._extract_cache.move_to_end(key)
                return self._extract_cache[key]
        out = self.extract_voice_tokens(audio_path)
        with self._extract_cache_lock:
            self._extract_cache[key] = out
            while len(self._extract_cache) > self._extract_cache_cap:
                self._extract_cache.popitem(last=False)
        return out

    def synthesize(self, args: TtsArgs) -> SynthesisResult:
        return self.synthesize_batch([args])[0]

    def vocode(self, g: GenerationResult) -> np.ndarray:
        """One request's tokens → f32 waveform @16 kHz (bucketed BiCodec
        detokenize; an empty generation gives 1 s of silence,
        lightweight_tts_pipeline.rs:828-830). While the recorder is on the
        call is its ``vocode`` span (n = latents) under ``g.trace_id``."""
        if not g.semantic_tokens:
            return np.zeros(C.SAMPLE_RATE, np.float32)
        with trace.scope("vocode", g.trace_id, len(g.semantic_tokens)) \
                if trace.on else trace.OFF:
            return bicodec.detokenize(
                self.bicodec_params, g.global_tokens or [0] * 32,
                g.semantic_tokens, self.bicodec_cfg,
                graphs=self.decode_graphs)[0]

    def assemble_result(self, g: GenerationResult, wav: np.ndarray,
                        timings_ms: Dict[str, float]) -> SynthesisResult:
        """One continuous-engine generation packaged as ``synthesize_batch``
        packages a static batch, with the same RTF accounting: serving wall
        per second of audio that wall produced."""
        total_s = sum(timings_ms.values()) / 1000.0
        audio_s = len(wav) / C.SAMPLE_RATE
        return SynthesisResult(
            audio=wav, sample_rate=C.SAMPLE_RATE,
            global_tokens=g.global_tokens,
            semantic_tokens=g.semantic_tokens, timings_ms=dict(timings_ms),
            rtf=(total_s / audio_s) if audio_s > 0 else 0.0)

    def synthesize_batch(self, requests: Sequence[TtsArgs]
                         ) -> List[SynthesisResult]:
        timer = StageTimer()
        resolved = [self.resolve_voice(a) for a in requests]

        with timer.stage("generate"):
            # group by mode, preserving order
            normal = [i for i, r in enumerate(resolved) if not r.zero_shot]
            zshot = [i for i, r in enumerate(resolved) if r.zero_shot]
            gens: List[Optional[GenerationResult]] = [None] * len(resolved)
            for group in (normal, zshot):
                if group:
                    for i, g in zip(group, self.engine.generate_batch(
                            [resolved[i] for i in group])):
                        gens[i] = g

        with timer.stage("detokenize"):
            audios = [self.vocode(g) for g in gens]

        # RTF = serving wall per second of audio that wall produced, over
        # the whole batch (bin/server.rs:631-676)
        total_s = timer.total_seconds()
        total_audio_s = sum(len(w) for w in audios) / C.SAMPLE_RATE
        batch_rtf = (total_s / total_audio_s) if total_audio_s > 0 else 0.0
        return [SynthesisResult(audio=wav, sample_rate=C.SAMPLE_RATE,
                                global_tokens=g.global_tokens,
                                semantic_tokens=g.semantic_tokens,
                                timings_ms=timer.as_ms(), rtf=batch_rtf)
                for g, wav in zip(gens, audios)]

    def enroll_voice(self, audio_path: str, name: str, prompt_text: str = ""):
        """Extract a reference file's tokens and save them as a voice of the
        store; returns its ``VoiceFeature``."""
        if self.voice_store is None:
            raise RuntimeError("no voice store configured")
        glob, sem, dur = self.extract_voice_tokens(audio_path)
        return self.voice_store.save(
            name=name, prompt_text=prompt_text, global_tokens=glob,
            semantic_tokens=sem, audio_duration=dur,
            sample_rate=C.SAMPLE_RATE)

    @staticmethod
    def save_audio(result: SynthesisResult, path: str) -> None:
        """MP3 by the path's suffix (``audio_io.encode_mp3``), else 16-bit
        PCM WAV."""
        if path.lower().endswith(".mp3"):
            blob = audio_io.encode_mp3(result.audio, result.sample_rate)
        else:
            blob = audio_io.encode_wav_16bit(result.audio, result.sample_rate)
        with open(path, "wb") as f:
            f.write(blob)

    def warmup(self, prefill_buckets=None, detok_buckets=(64, 256, 1024),
               zero_shot_too: bool = True, batch_ladder=None,
               budget_s: Optional[float] = None) -> Dict[str, object]:
        """Run every serving shape once before traffic arrives, each with a
        hard limit of one semantic token: eager PyTorch compiles nothing,
        but the first call of a shape builds and loads the kernels, creates
        the library handles and grows the allocator's pools, and on a card
        captures the CUDA graphs of that shape: the static engine's stages
        and prefill chunks of that batch, the detokenize buckets' and the
        streaming windows' vocoder programs. Returns wall
        seconds by step, under the JAX pipeline's labels
        (``_warmup_pipeline``, ``pipeline.py:428``).

        ``batch_ladder``: the static engine's batch widths to run, by
        default every width ``generate_batch`` can pad to, {1, 2, 4, …} ∪
        {batch_size}. ``budget_s``: once this much wall time has passed,
        the remaining steps are skipped and listed under ``"skipped"``.
        The steps run in the JAX order: the batch ladder over the first two
        prefill buckets and both modes (``TtsEngine.lm_program``), a
        prompt longer than the largest bucket through prefill, the global
        and the semantic stage, the speaker cache (when it is the
        default), the detokenize buckets, then both vocoder windows of
        every streaming latency mode. Under a ``tp_mesh`` every batch pads
        to the data axis, so the LM steps run the TP path at that batch
        (``batch_ladder`` is ignored)."""
        from .streaming import StreamingVocoder

        eng = self.engine
        ecfg, dev = eng.engine_cfg, eng.device
        out: Dict[str, object] = {}
        skipped: List[str] = []
        t_warm0 = time.perf_counter()

        def over(label: str) -> bool:
            if budget_s is not None and \
                    time.perf_counter() - t_warm0 > budget_s:
                skipped.append(label)
                return True
            return False

        def timed(label: str, fn) -> None:
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out[label] = round(time.perf_counter() - t0, 2)

        def ones(B):
            return torch.ones((B,), dtype=torch.int64, device=dev)

        def semantic(state, logits, B, zs):
            eng.run_semantic(state, logits, eng._keys([0] * B, 0), ones(B),
                             ones(B) - 1, zs, not zs)

        def lm(B, T, zs):
            # the static engine's serving chain at (B, T) on zero tokens:
            # lm_program as in the JAX warm-up; on a card it captures the
            # prefill's and the stages' graphs of batch B
            keys = eng._keys([0] * B, 0)
            eng.lm_program([[0] * T] * B, keys, keys, ones(B), ones(B) - 1,
                           zs)

        modes = (False, True) if zero_shot_too else (False,)
        buckets = prefill_buckets or ecfg.prefill_buckets[:2]
        # the smallest batch the engine runs: a tensor-parallel engine
        # pads every batch to its data axis
        B1 = 1 if eng.tp_mesh is None else eng.tp_mesh.dp
        if eng.tp_mesh is not None:
            batch_ladder = [B1]
        elif batch_ladder is None:
            batch_ladder, b = [], 1
            while b < ecfg.batch_size:
                batch_ladder.append(b)
                b *= 2
            batch_ladder.append(ecfg.batch_size)
        for B in batch_ladder:
            for T in buckets:
                for zs in modes:
                    label = f"lm_{'zs' if zs else 'normal'}_{T}_b{B}"
                    if not over(label):
                        timed(label, lambda: lm(B, T, zs))
        # a prompt longer than the largest bucket prefills in chunks of
        # that bucket; the stages feed each other, so one budget guard
        if not over("staged_long_prompt"):
            Tmax = ecfg.prefill_buckets[-1]
            box = {}

            def prefill():
                box["lg"], box["st"] = eng.prefill([[0] * Tmax] * B1,
                                                   eng.init_state(B1))

            def glob():
                _, box["st"], box["lg"] = eng.run_global(
                    box["st"], box["lg"], eng._keys([0] * B1, 0))

            timed(f"prefill_{Tmax}", prefill)
            with eng.stage_lock:
                timed("global_stage", glob)
                for zs in modes:
                    # semantic_stage updates the state in place: each mode
                    # starts from its own copy (on a card, of the graphs'
                    # buffers, which the first mode has moved on: tokens of
                    # a warm-up are not kept)
                    timed(f"semantic_{'zs' if zs else 'normal'}",
                          lambda: semantic({k: v.clone() for k, v in
                                            box["st"].items()}, box["lg"],
                                           B1, zs))
        if self.cached_speaker_default and not over("speaker_cache"):
            # requests without a seed resolve under the seed=None key, a
            # speaker of its own: warm both keys
            timed("speaker_cache", lambda: (
                self.get_cached_speaker(TtsArgs(text="", seed=0)),
                self.get_cached_speaker(TtsArgs(text="", seed=None))))
        for S in detok_buckets:
            if not over(f"detokenize_{S}"):
                timed(f"detokenize_{S}", lambda: bicodec.detokenize(
                    self.bicodec_params, [0] * 32, [0] * S,
                    self.bicodec_cfg, graphs=self.decode_graphs))
        # streaming decodes two window lengths per latency mode (interior
        # and flush), outside the detokenize buckets; on a card each
        # captures its window's graph, as each detokenize bucket does
        codec = self.bicodec_params

        def window(W):
            return bicodec.decode_host(codec, [[0] * 32], [[0] * W],
                                       self.bicodec_cfg, self.decode_graphs)

        for mode in ("exact", "low", "ultra", "flash"):
            sv = StreamingVocoder(codec, self.bicodec_cfg, [0] * 32,
                                  latency_mode=mode)
            for W in sorted({sv.window_bucket, sv.flush_bucket}):
                if not over(f"stream_{mode}_{W}"):
                    timed(f"stream_{mode}_{W}", lambda: window(W))
        if skipped:
            out["skipped"] = skipped
            log.warning("warmup budget %.1fs exhausted: %d steps skipped "
                        "(%s…); they warm on first use", budget_s or 0.0,
                        len(skipped), ", ".join(skipped[:4]))
        return out

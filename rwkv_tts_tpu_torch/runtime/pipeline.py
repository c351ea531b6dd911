"""End-to-end TTS pipeline: text → tokens → waveform.

Port of ``rwkv_tts_tpu/runtime/pipeline.TtsPipeline`` restricted to this
slice: property-controlled synthesis and zero-shot from direct reference
tokens. ``synthesize_batch`` keeps the JAX pipeline's mode grouping, stage
timings and RTF accounting (``pipeline.py:309-349``). Cloning from
reference audio, the voice store and the cached speaker are not ported yet
and raise ``NotImplementedError`` rather than doing something else.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import constants as C
from ..audio import io as audio_io
from ..config import BiCodecConfig, EngineConfig, RwkvConfig, TtsArgs
from ..models import bicodec
from ..utils.device import resolve_device
from ..utils.rtf import StageTimer
from .engine import GenerationResult, TtsEngine

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
    """Owns the LM engine and the BiCodec decoder. Parameters are the
    port's tensor dicts, already on ``device`` (``utils/bridge.py`` or the
    models' ``init_params``)."""

    def __init__(self, lm_params, lm_cfg: RwkvConfig, bicodec_params,
                 bicodec_cfg: BiCodecConfig,
                 engine_cfg: EngineConfig = EngineConfig(), tokenizer=None,
                 device=None):
        self.device = resolve_device(device)
        self.engine = TtsEngine(lm_params, lm_cfg, engine_cfg,
                                tokenizer=tokenizer, device=self.device)
        self.bicodec_params = bicodec_params
        self.bicodec_cfg = bicodec_cfg

    def resolve_voice(self, args: TtsArgs) -> TtsArgs:
        """The voice chain's rungs this slice has: direct reference tokens
        (zero-shot, seed forced to 0 as the reference does for cloning,
        dynamic_batch_manager.rs:487), else property tokens."""
        if args.voice_id:
            log.warning("voice_id %r ignored: no voice store configured",
                        args.voice_id)
        if args.ref_global_tokens:
            return dataclasses.replace(args, zero_shot=True, seed=0)
        if args.ref_audio_path:
            raise NotImplementedError(
                "cloning from reference audio is not ported yet")
        if args.cached_speaker:
            raise NotImplementedError(
                "the cached-speaker path is not ported yet")
        return dataclasses.replace(args, zero_shot=False)

    def vocode(self, g: GenerationResult) -> np.ndarray:
        """One request's tokens → f32 waveform @16 kHz (bucketed BiCodec
        detokenize; an empty generation gives 1 s of silence,
        lightweight_tts_pipeline.rs:828-830)."""
        if g.semantic_tokens:
            return bicodec.detokenize(
                self.bicodec_params, g.global_tokens or [0] * 32,
                g.semantic_tokens, self.bicodec_cfg)[0]
        return np.zeros(C.SAMPLE_RATE, np.float32)

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

    @staticmethod
    def save_audio(result: SynthesisResult, path: str) -> None:
        """16-bit PCM WAV (MP3 is not ported yet)."""
        if path.lower().endswith(".mp3"):
            raise NotImplementedError("MP3 output is not ported yet")
        with open(path, "wb") as f:
            f.write(audio_io.encode_wav_16bit(result.audio,
                                              result.sample_rate))

"""16-bit PCM WAV writer; the port's own copy of ``encode_wav_16bit`` from
``rwkv_tts_tpu/audio/io.py`` (the reference server's dynamic gain,
bin/server.rs:98-148)."""

from __future__ import annotations

import io
import struct

import numpy as np


def encode_wav_16bit(samples: np.ndarray, sample_rate: int = 16000) -> bytes:
    """f32 PCM → mono 16-bit WAV bytes: peaks > 1 are normalized down;
    quiet signals are boosted toward 0.8 peak, capped at 10×."""
    samples = np.asarray(samples, np.float32)
    max_abs = float(np.max(np.abs(samples))) if samples.size else 0.0
    if max_abs > 0.0:
        scale = (1.0 / max_abs) if max_abs > 1.0 else min(0.8 / max_abs, 10.0)
    else:
        scale = 1.0
    ints = np.clip(samples * scale, -1.0, 1.0) * 32767.0
    pcm = ints.astype(np.int16).tobytes()

    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(pcm)))
    buf.write(b"WAVE")
    buf.write(b"fmt ")
    buf.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2,
                          2, 16))
    buf.write(b"data")
    buf.write(struct.pack("<I", len(pcm)))
    buf.write(pcm)
    return buf.getvalue()

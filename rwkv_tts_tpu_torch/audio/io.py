"""Audio file I/O: WAV decode and the 16-bit PCM WAV writer.

The port's own copy of ``read_wav``, ``read_wav_file``, ``read_audio_file``
and ``encode_wav_16bit`` from ``rwkv_tts_tpu/audio/io.py``: a
self-contained RIFF parser for PCM 8/16/24/32-bit, IEEE float 32/64 and
WAVE_FORMAT_EXTENSIBLE (the stdlib ``wave`` module cannot read float or
24-bit files), and the reference server's dynamic-gain writer
(bin/server.rs:98-148). MP3 decode and encode are not ported yet.
"""

from __future__ import annotations

import io
import struct
from typing import Tuple

import numpy as np


class AudioDecodeError(ValueError):
    pass


def read_wav(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Parse a RIFF/WAVE byte string → (interleaved float32 samples, sample
    rate, channels)."""
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AudioDecodeError("not a RIFF/WAVE file")
    pos = 12
    fmt = fmt_body = raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise AudioDecodeError("missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # the real format tag is the first 2 bytes of the SubFormat GUID
        # (fmt-body offset 24)
        if len(fmt_body) >= 26:
            (audio_format,) = struct.unpack_from("<H", fmt_body, 24)
        else:
            audio_format = 1  # short extensible header: PCM in practice
    if audio_format == 1:  # PCM
        if bits == 16:
            samples = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8)
            b = b[: len(b) - len(b) % 3].reshape(-1, 3)
            vals = (b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            samples = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            samples = (np.frombuffer(raw, "<i4").astype(np.float32)
                       / float(1 << 31))
        elif bits == 8:
            samples = (np.frombuffer(raw, np.uint8).astype(np.float32)
                       - 128.0) / 128.0
        else:
            raise AudioDecodeError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            samples = np.frombuffer(raw, "<f4").astype(np.float32)
        elif bits == 64:
            samples = np.frombuffer(raw, "<f8").astype(np.float32)
        else:
            raise AudioDecodeError(f"unsupported float bit depth {bits}")
    else:
        raise AudioDecodeError(f"unsupported WAV format tag {audio_format}")
    return samples, int(sample_rate), int(channels)


def read_wav_file(path: str) -> Tuple[np.ndarray, int, int]:
    with open(path, "rb") as f:
        return read_wav(f.read())


def read_audio_file(path: str) -> Tuple[np.ndarray, int, int]:
    """WAV file → (interleaved float32 samples, rate, channels)."""
    if path.lower().endswith(".mp3"):
        raise NotImplementedError("MP3 input is not ported yet; provide WAV")
    return read_wav_file(path)


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

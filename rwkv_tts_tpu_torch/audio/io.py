"""Audio file I/O: WAV and MP3 decode, the 16-bit PCM WAV writer, MP3
encode.

The port's own copy of ``rwkv_tts_tpu/audio/io.py``: a self-contained RIFF
parser for PCM 8/16/24/32-bit, IEEE float 32/64 and
WAVE_FORMAT_EXTENSIBLE (the stdlib ``wave`` module cannot read float or
24-bit files), the reference server's dynamic-gain writer
(bin/server.rs:98-148), MP3 decode through libmpg123, then ffmpeg, then
SDL_mixer (pygame), and MP3 encode through libmp3lame (the reference's own
encoder), then ffmpeg.
"""

from __future__ import annotations

import io
import os
import shutil
import struct
import subprocess
import threading
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


def _ffmpeg():
    return shutil.which("ffmpeg")


# SDL_mixer (via pygame) decodes MP3 in-process. The mixer converts to its
# open format at load, so everything comes out at this fixed spec; the
# front end's resampler takes it to 16 kHz from there.
_SDL_RATE = 44100
_SDL_CHANNELS = 2
_sdl_lock = threading.Lock()
_sdl_state: list = []  # [] = untried, [pygame] = ready, [None] = unavailable


def _sdl_mixer():
    """Headless SDL_mixer init, once per process; None when unavailable."""
    with _sdl_lock:
        if not _sdl_state:
            try:
                os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
                os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")
                import pygame

                pygame.mixer.init(frequency=_SDL_RATE, size=-16,
                                  channels=_SDL_CHANNELS)
                _sdl_state.append(pygame)
            except Exception:  # noqa: BLE001: any failure means no backend
                _sdl_state.append(None)
        return _sdl_state[0]


def _read_mp3_sdl(path: str) -> Tuple[np.ndarray, int, int]:
    """MP3 → interleaved float32 via SDL_mixer at the fixed mixer spec."""
    pygame = _sdl_mixer()
    if pygame is None:
        raise AudioDecodeError(
            "MP3 decode requires ffmpeg or SDL_mixer (pygame), neither of "
            "which is available; provide WAV input instead"
        )
    import pygame.sndarray
    try:
        with _sdl_lock:
            arr = pygame.sndarray.array(pygame.mixer.Sound(path))
    except Exception as e:  # pygame.error on corrupt/unsupported files
        raise AudioDecodeError(f"MP3 decode failed: {e}") from e
    samples = (np.asarray(arr, np.float32) / 32768.0).reshape(-1)
    channels = arr.shape[1] if arr.ndim == 2 else 1
    return samples, _SDL_RATE, channels


def read_mp3_file(path: str) -> Tuple[np.ndarray, int, int]:
    """Decode MP3 → (interleaved float32, rate, channels). The reference
    links symphonia (src/ref_audio_utilities.rs:288-330); here, in order:
    in-process libmpg123 (native-rate decode), ffmpeg when installed, else
    SDL_mixer (decodes at a fixed 44.1 kHz spec; the front end resamples
    to 16 kHz anyway)."""
    from . import mp3 as _mp3
    if _mp3.mpg123_available():
        try:
            return _mp3.decode_mp3_mpg123(path)
        except RuntimeError as e:
            raise AudioDecodeError(f"MP3 decode failed: {e}") from e
    ff = _ffmpeg()
    if not ff:
        return _read_mp3_sdl(path)
    out = subprocess.run(
        [ff, "-v", "error", "-i", path, "-f", "wav", "-acodec", "pcm_s16le", "-"],
        capture_output=True, check=True,
    ).stdout
    return read_wav(out)


def read_audio_file(path: str) -> Tuple[np.ndarray, int, int]:
    """WAV or MP3 file (by its suffix) → (interleaved float32 samples,
    rate, channels)."""
    if path.lower().endswith(".mp3"):
        return read_mp3_file(path)
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


def encode_mp3(samples: np.ndarray, sample_rate: int = 16000,
               bitrate: str = "128k") -> bytes:
    """MP3 encode matching the reference's mp3lame-encoder settings
    (src/lightweight_tts_pipeline.rs:1031-1121: mono CBR 128 kbps, quality
    Best, plain clamp → i16; the dynamic gain applies only to the API's
    base64 WAV, bin/server.rs:98-148). In-process libmp3lame when present,
    else ffmpeg's libmp3lame."""
    kbps = int(str(bitrate).lower().rstrip("k")) if bitrate else 128
    from . import mp3 as _mp3
    if _mp3.lame_available():
        try:
            return _mp3.encode_mp3_lame(samples, sample_rate,
                                        bitrate_kbps=kbps)
        except RuntimeError as e:
            raise AudioDecodeError(f"MP3 encode failed: {e}") from e
    ff = _ffmpeg()
    if not ff:
        raise AudioDecodeError(
            "MP3 encode requires libmp3lame or ffmpeg (neither installed)")
    pcm = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    wav = _plain_wav_16bit(pcm, sample_rate)
    return subprocess.run(
        [ff, "-v", "error", "-f", "wav", "-i", "-", "-b:a", f"{kbps}k",
         "-f", "mp3", "-"],
        input=wav, capture_output=True, check=True,
    ).stdout


def _plain_wav_16bit(samples: np.ndarray, sample_rate: int) -> bytes:
    """Clamp → i16 WAV with NO dynamic gain (the reference's file-save
    conversion, src/lightweight_tts_pipeline.rs:1041-1048)."""
    ints = np.clip(np.asarray(samples, np.float32), -1.0, 1.0) * 32767.0
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

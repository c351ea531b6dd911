"""In-process MP3 codec via the system LAME / mpg123 shared libraries.

The port's own copy of ``rwkv_tts_tpu/audio/mp3.py`` (it has no JAX in
it). The reference links LAME for MP3 *encode* (``mp3lame-encoder`` crate,
src/lightweight_tts_pipeline.rs:1031-1121: mono, CBR 128 kbps, quality
Best, FlushNoGap) and symphonia for *decode*
(src/ref_audio_utilities.rs:288-330). Here the same native codecs are
bound with ctypes — ``libmp3lame.so.0`` for encode, ``libmpg123.so.0``
for native-rate decode — so neither path needs an external ``ffmpeg``
binary. Both are optional: callers fall back to ffmpeg / SDL_mixer via
:mod:`rwkv_tts_tpu_torch.audio.io` when a library is absent. Each library
is loaded once, at first use, under its lock.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "lame_available",
    "mpg123_available",
    "encode_mp3_lame",
    "decode_mp3_mpg123",
]


def _load(names) -> Optional[ctypes.CDLL]:
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError:
            continue
    return None


# ---------------------------------------------------------------------------
# LAME encode
# ---------------------------------------------------------------------------

_lame_lock = threading.Lock()
_lame_state: list = []  # [] untried, [lib] ready, [None] unavailable

_LAME_MONO = 3  # MPEG_mode MONO (lame.h)


def _lame() -> Optional[ctypes.CDLL]:
    with _lame_lock:
        if not _lame_state:
            lib = _load(["libmp3lame.so.0", "libmp3lame.so", "libmp3lame.dylib"])
            if lib is not None:
                try:
                    lib.lame_init.restype = ctypes.c_void_p
                    for f in ("lame_set_num_channels", "lame_set_in_samplerate",
                              "lame_set_brate", "lame_set_quality",
                              "lame_set_mode", "lame_init_params",
                              "lame_close"):
                        getattr(lib, f).restype = ctypes.c_int
                        getattr(lib, f).argtypes = (
                            [ctypes.c_void_p] if f in ("lame_init_params",
                                                       "lame_close")
                            else [ctypes.c_void_p, ctypes.c_int])
                    lib.lame_encode_buffer.restype = ctypes.c_int
                    lib.lame_encode_buffer.argtypes = [
                        ctypes.c_void_p,
                        ctypes.POINTER(ctypes.c_short),
                        ctypes.POINTER(ctypes.c_short),
                        ctypes.c_int,
                        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
                    lib.lame_encode_flush_nogap.restype = ctypes.c_int
                    lib.lame_encode_flush_nogap.argtypes = [
                        ctypes.c_void_p,
                        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
                except AttributeError:
                    lib = None
            _lame_state.append(lib)
        return _lame_state[0]


def lame_available() -> bool:
    return _lame() is not None


def encode_mp3_lame(samples: np.ndarray, sample_rate: int = 16000,
                    bitrate_kbps: int = 128, quality: int = 0) -> bytes:
    """f32 mono PCM → MP3 bytes with the reference's encoder settings
    (src/lightweight_tts_pipeline.rs:1041-1068: clamp → i16 scale by
    32767, mono, CBR ``bitrate_kbps``, ``quality`` 0 = Best, flush with
    FlushNoGap). Raises ``RuntimeError`` when libmp3lame is absent or an
    encoder call fails."""
    lib = _lame()
    if lib is None:
        raise RuntimeError("libmp3lame not available")
    pcm = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm_i16 = np.ascontiguousarray((pcm * 32767.0).astype(np.int16))
    n = int(pcm_i16.size)

    gfp = lib.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        for setter, val in (("lame_set_num_channels", 1),
                            ("lame_set_in_samplerate", int(sample_rate)),
                            ("lame_set_brate", int(bitrate_kbps)),
                            ("lame_set_quality", int(quality)),
                            ("lame_set_mode", _LAME_MONO)):
            if getattr(lib, setter)(gfp, val) != 0:
                raise RuntimeError(f"{setter}({val}) failed")
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError(
                f"lame_init_params failed (rate={sample_rate}, "
                f"brate={bitrate_kbps})")

        out_cap = n + n // 4 + 7200  # lame.h guidance: 1.25*n + 7200
        buf = (ctypes.c_ubyte * out_cap)()
        pcm_ptr = pcm_i16.ctypes.data_as(ctypes.POINTER(ctypes.c_short))
        # mono: LAME ignores the right-channel buffer; pass left twice so
        # the pointer is always valid
        written = lib.lame_encode_buffer(gfp, pcm_ptr, pcm_ptr, n, buf, out_cap)
        if written < 0:
            raise RuntimeError(f"lame_encode_buffer error {written}")
        out = ctypes.string_at(buf, written)  # one memcpy, no per-byte boxing

        flush_buf = (ctypes.c_ubyte * 7200)()
        flushed = lib.lame_encode_flush_nogap(gfp, flush_buf, 7200)
        if flushed < 0:
            raise RuntimeError(f"lame_encode_flush_nogap error {flushed}")
        return out + ctypes.string_at(flush_buf, flushed)
    finally:
        lib.lame_close(gfp)


# ---------------------------------------------------------------------------
# mpg123 decode
# ---------------------------------------------------------------------------

_mpg_lock = threading.Lock()
_mpg_state: list = []

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_SIGNED_16 = 0xD0  # mpg123.h: ENC_16|ENC_SIGNED|0x10


def _mpg123() -> Optional[ctypes.CDLL]:
    with _mpg_lock:
        if not _mpg_state:
            lib = _load(["libmpg123.so.0", "libmpg123.so", "libmpg123.dylib"])
            if lib is not None:
                try:
                    lib.mpg123_init.restype = ctypes.c_int
                    lib.mpg123_new.restype = ctypes.c_void_p
                    lib.mpg123_new.argtypes = [ctypes.c_char_p,
                                               ctypes.POINTER(ctypes.c_int)]
                    lib.mpg123_open.restype = ctypes.c_int
                    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                    lib.mpg123_getformat.restype = ctypes.c_int
                    lib.mpg123_getformat.argtypes = [
                        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                        ctypes.POINTER(ctypes.c_int),
                        ctypes.POINTER(ctypes.c_int)]
                    lib.mpg123_format_none.restype = ctypes.c_int
                    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
                    lib.mpg123_format.restype = ctypes.c_int
                    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                                  ctypes.c_int, ctypes.c_int]
                    lib.mpg123_read.restype = ctypes.c_int
                    lib.mpg123_read.argtypes = [
                        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
                        ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
                    lib.mpg123_close.restype = ctypes.c_int
                    lib.mpg123_close.argtypes = [ctypes.c_void_p]
                    lib.mpg123_delete.restype = None
                    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
                    lib.mpg123_init()  # no-op on modern libs, required on old
                except AttributeError:
                    lib = None
            _mpg_state.append(lib)
        return _mpg_state[0]


def mpg123_available() -> bool:
    return _mpg123() is not None


def decode_mp3_mpg123(path: str) -> Tuple[np.ndarray, int, int]:
    """MP3 file → (interleaved float32 samples, native rate, channels).
    Decodes at the stream's own sample rate (unlike the SDL_mixer fallback,
    which resamples to a fixed 44.1 kHz mixer spec)."""
    lib = _mpg123()
    if lib is None:
        raise RuntimeError("libmpg123 not available")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    try:
        if lib.mpg123_open(h, path.encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123_open failed for {path!r}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                                ctypes.byref(enc)) != _MPG123_OK:
            raise RuntimeError("mpg123_getformat failed")
        # lock the output format to s16 at the native rate
        lib.mpg123_format_none(h)
        if lib.mpg123_format(h, rate.value, channels.value,
                             _MPG123_ENC_SIGNED_16) != _MPG123_OK:
            raise RuntimeError("mpg123_format failed")

        chunks = []
        buf_sz = 1 << 16
        buf = (ctypes.c_ubyte * buf_sz)()
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, buf_sz, ctypes.byref(done))
            if done.value:
                chunks.append(ctypes.string_at(buf, done.value))
            if rc == _MPG123_DONE:
                break
            if rc == _MPG123_NEW_FORMAT:
                continue  # format is locked; informational
            if rc != _MPG123_OK:
                raise RuntimeError(f"mpg123_read error {rc}")
        raw = b"".join(chunks)
        if not raw:
            raise RuntimeError("mpg123 produced no samples")
        samples = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        return samples, int(rate.value), int(channels.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)

"""The port's reference-audio front end against the JAX package's on the
same inputs: WAV decoding, resampling, the mel spectrogram and the chain of
``load_and_process``. Both sides are NumPy/SciPy on the host, so they agree
exactly."""

import struct

import numpy as np
import pytest

from rwkv_tts_tpu_torch.audio import frontend as P
from rwkv_tts_tpu_torch.audio import io as Pio
from rwkv_tts_tpu_torch.ops import mel as Pmel
from rwkv_tts_tpu_torch.ops import resample as Pres


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    from rwkv_tts_tpu.audio import frontend, io
    from rwkv_tts_tpu.ops import mel, resample
    return {"frontend": frontend, "io": io, "mel": mel, "resample": resample}


def speech_like(n, sr, seed):
    """A few seconds of voiced-sounding noise with silent edges."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.7 * t)
    x = sum(np.sin(2 * np.pi * h * np.cumsum(f0) / sr) / h for h in (1, 2, 3))
    x = 0.3 * x * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) \
        + 0.02 * rng.standard_normal(n)
    x[: n // 20] = 0.0
    x[-n // 20:] = 0.001 * rng.standard_normal(n // 20)
    return x.astype(np.float32)


def wav_bytes(samples, sr, channels, fmt, bits, extensible=False):
    """A RIFF/WAVE file of interleaved ``samples`` in the given encoding."""
    if fmt == 3:
        raw = samples.astype("<f4" if bits == 32 else "<f8").tobytes()
    elif bits == 8:
        raw = np.clip(samples * 128 + 128, 0, 255).astype(np.uint8).tobytes()
    elif bits == 16:
        raw = (samples * 32767).astype("<i2").tobytes()
    elif bits == 24:
        v = (samples * (2 ** 23 - 1)).astype(np.int32)
        raw = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255],
                       -1).astype(np.uint8).tobytes()
    else:
        raw = (samples * (2 ** 31 - 1)).astype("<i4").tobytes()
    block = channels * bits // 8
    fmt_body = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt,
                           channels, sr, sr * block, block, bits)
    if extensible:
        fmt_body += struct.pack("<HHI", 22, bits, 0) \
            + struct.pack("<H", fmt) + b"\x00" * 14
    chunks = (b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
              + b"LIST" + struct.pack("<I", 3) + b"abc\x00"
              + b"data" + struct.pack("<I", len(raw)) + raw)
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


@pytest.mark.parametrize("fmt,bits,extensible", [
    (1, 8, False), (1, 16, False), (1, 24, False), (1, 32, False),
    (3, 32, False), (3, 64, False), (3, 32, True), (1, 24, True)])
def test_read_wav_matches_jax(J, fmt, bits, extensible):
    x = np.clip(speech_like(3000, 16000, bits), -0.99, 0.99)
    blob = wav_bytes(np.stack([x, -x], -1).reshape(-1), 22050, 2, fmt, bits,
                     extensible)
    got, sr, ch = Pio.read_wav(blob)
    want, wsr, wch = J["io"].read_wav(blob)
    assert (sr, ch) == (wsr, wch) == (22050, 2)
    np.testing.assert_array_equal(got, want)


NO_DATA = (b"RIFF" + struct.pack("<I", 40) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
           + b"LIST" + struct.pack("<I", 8) + b"\x00" * 8)
ALAW = wav_bytes(np.zeros(8, np.float32), 8000, 1, 1, 16)
ALAW = ALAW[:20] + struct.pack("<H", 6) + ALAW[22:]


@pytest.mark.parametrize("blob", [NO_DATA, ALAW, b"not a wav" * 10],
                         ids=["no_data", "a_law", "not_riff"])
def test_read_wav_rejects_what_jax_rejects(J, blob):
    with pytest.raises(Pio.AudioDecodeError):
        Pio.read_wav(blob)
    with pytest.raises(J["io"].AudioDecodeError):
        J["io"].read_wav(blob)


def test_mp3_input_raises_not_ported(J, tmp_path):
    """MP3 input is ported (tests/test_torch_mp3.py holds it against the
    JAX reader): a file named .mp3 that holds no MP3 stream raises the JAX
    reader's error, word for word."""
    path = tmp_path / "ref.mp3"
    path.write_bytes(b"ID3" + b"\x00" * 100)
    with pytest.raises(Exception) as mine:
        Pio.read_audio_file(str(path))
    with pytest.raises(Exception) as theirs:
        J["io"].read_audio_file(str(path))
    assert type(mine.value).__name__ == type(theirs.value).__name__
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("rates", [(24000, 16000), (44100, 16000),
                                   (8000, 16000), (16000, 16000)])
def test_resample_matches_jax(J, rates):
    x = speech_like(9000, rates[0], seed=1)
    np.testing.assert_array_equal(Pres.resample(x, *rates),
                                  J["resample"].resample(x, *rates))


def test_mel_matches_jax(J):
    clip = speech_like(96000, 16000, seed=2)
    got = Pmel.mel_spectrogram(clip)
    assert got.shape == (128, 301) and got.dtype == np.float32
    np.testing.assert_array_equal(got, J["mel"].mel_spectrogram(clip))
    np.testing.assert_array_equal(Pmel.mel_filterbank(),
                                  J["mel"].mel_filterbank())
    np.testing.assert_array_equal(Pmel.hann_window(), J["mel"].hann_window())
    short = speech_like(500, 16000, seed=3)
    np.testing.assert_array_equal(Pmel.mel_spectrogram(short),
                                  J["mel"].mel_spectrogram(short))


@pytest.mark.parametrize("case", ["normal", "quiet", "silent", "short",
                                  "single"])
def test_frontend_steps_match_jax(J, case):
    F = J["frontend"]
    x = {"normal": speech_like(40000, 16000, seed=4),
         "quiet": 0.01 * speech_like(40000, 16000, seed=5),
         "silent": np.zeros(3000, np.float32),
         "short": speech_like(700, 16000, seed=6),
         "single": np.array([0.5], np.float32)}[case]
    for name in ("volume_normalize", "trim_silence",
                 "zero_mean_unit_variance", "get_ref_clip"):
        np.testing.assert_array_equal(getattr(P, name)(x),
                                      getattr(F, name)(x), err_msg=name)
    inter = np.stack([x, 2 * x], -1).reshape(-1)
    np.testing.assert_array_equal(P.to_mono_first_channel(inter, 2),
                                  F.to_mono_first_channel(inter, 2))


@pytest.mark.parametrize("sr,channels", [(16000, 1), (24000, 2)])
def test_load_and_process_matches_jax(J, tmp_path, sr, channels):
    x = speech_like(sr * 4, sr, seed=sr)
    path = tmp_path / "ref.wav"
    path.write_bytes(wav_bytes(np.repeat(x, channels), sr, channels, 3, 32))
    got = P.load_and_process(str(path))
    want = J["frontend"].load_and_process(str(path))
    assert got.ref_mel.shape == (128, 301)
    for field in ("wav", "ref_clip", "ref_mel"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.duration == want.duration and got.sample_rate == 16000


def test_load_and_process_rejects_a_too_short_file(tmp_path):
    path = tmp_path / "tiny.wav"
    path.write_bytes(wav_bytes(speech_like(1000, 16000, 7), 16000, 1, 1, 16))
    with pytest.raises(ValueError, match="too short"):
        P.load_and_process(str(path))

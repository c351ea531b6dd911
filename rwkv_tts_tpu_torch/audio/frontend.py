"""Reference-audio front end: the preprocessing chain for voice cloning.

The port's own copy of ``rwkv_tts_tpu/audio/frontend.py`` (parity contract
with the reference's ``RefAudioUtilities::load_audio``,
src/ref_audio_utilities.rs:115-222, and its ``tokenize`` chain, :1047-1257):

  decode → first channel → resample to 16 kHz → percentile volume
  normalize (coeff 0.2) → trim leading/trailing silence (|x| ≤ 0.01) →
  { wav2vec2 z-norm features over the whole wav ;
    6-s reference clip (repeat-padded) → mel [128, 301] }

All of it is NumPy on the host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import LATENT_HOP_LENGTH, REF_SEGMENT_DURATION, SAMPLE_RATE
from ..ops.mel import mel_spectrogram
from ..ops.resample import resample
from .io import read_audio_file


def to_mono_first_channel(samples: np.ndarray, channels: int) -> np.ndarray:
    """Multi-channel → the first channel (not an average), as the reference
    does (src/ref_audio_utilities.rs:178-188)."""
    if channels <= 1:
        return samples
    n = len(samples) // channels
    return samples[: n * channels].reshape(n, channels)[:, 0].copy()


def volume_normalize(audio: np.ndarray, coeff: float = 0.2) -> np.ndarray:
    """Percentile-based loudness normalization
    (src/ref_audio_utilities.rs:589-631)."""
    audio = np.asarray(audio, np.float32).copy()
    temp = np.sort(np.abs(audio))
    if temp.size == 0:
        return audio
    if temp[-1] < 0.1:
        scale = max(float(temp[-1]), 1e-3)
        audio = audio / scale * 0.1
    temp = temp[temp > 0.01]
    L = temp.size
    if L <= 10:
        return audio
    volume = float(np.mean(temp[int(0.9 * L): int(0.99 * L)]))
    audio = audio * np.clip(coeff / volume, 0.1, 10.0)
    max_value = float(np.max(np.abs(audio)))
    if max_value > 1.0:
        audio = audio / max_value
    return audio


def trim_silence(audio: np.ndarray, threshold: float = 0.01) -> np.ndarray:
    """Cut leading and trailing |x| ≤ threshold; an all-silent signal
    becomes zeros of the original length
    (src/ref_audio_utilities.rs:1299-1356)."""
    audio = np.asarray(audio, np.float32)
    loud = np.abs(audio) > threshold
    if not loud.any():
        return np.zeros_like(audio)
    start = int(np.argmax(loud))
    end = len(audio) - int(np.argmax(loud[::-1]))
    return audio[start:end].copy()


def zero_mean_unit_variance(x: np.ndarray) -> np.ndarray:
    """wav2vec2 input normalization (src/ref_audio_utilities.rs:645-693):
    population variance, eps 1e-7."""
    x = np.asarray(x, np.float32)
    if x.size == 0:
        return x
    if x.size == 1:
        return np.zeros_like(x)
    mean = float(x.mean())
    if np.all(np.abs(x - mean) < 1e-10):
        return np.zeros_like(x)
    std = float(np.sqrt(((x - mean) ** 2).mean() + 1e-7))
    return (x - mean) / std


def get_ref_clip(wav: np.ndarray,
                 duration: float = REF_SEGMENT_DURATION,
                 sample_rate: int = SAMPLE_RATE,
                 hop: int = LATENT_HOP_LENGTH) -> np.ndarray:
    """The first hop-aligned ``duration`` seconds; shorter audio is tiled
    (src/ref_audio_utilities.rs:975-1011). 6 s at 16 kHz, hop 320 → 96000
    samples → 301 mel frames."""
    ref_len = int(duration * sample_rate) // hop * hop
    wav = np.asarray(wav, np.float32)
    if wav.size == 0:
        return np.zeros(ref_len, np.float32)
    if ref_len > wav.size:
        reps = ref_len // wav.size + 1
        return np.tile(wav, reps)[:ref_len].copy()
    return wav[:ref_len].copy()


@dataclasses.dataclass
class ProcessedAudio:
    wav: np.ndarray          # full preprocessed waveform @16 kHz
    ref_clip: np.ndarray     # 96000-sample reference clip
    ref_mel: np.ndarray      # [128, 301]
    duration: float          # seconds
    sample_rate: int


def load_and_process(path: str, volume_norm: bool = True,
                     target_sr: int = SAMPLE_RATE) -> ProcessedAudio:
    """The whole front-end chain from an audio file path."""
    samples, sr, channels = read_audio_file(path)
    if samples.size == 0:
        raise ValueError("audio file contains no samples")
    # the reference gates the minimum length on the interleaved sample
    # count, before the mono down-mix (ref_audio_utilities.rs:166-174)
    if samples.size < int(sr * 0.1):
        raise ValueError(f"audio too short: {samples.size / sr:.3f}s "
                         "(min 0.1s)")
    wav = to_mono_first_channel(samples, channels)
    if sr != target_sr:
        wav = resample(wav, sr, target_sr)
    if volume_norm:
        wav = volume_normalize(wav, 0.2)
    wav = trim_silence(wav, 0.01)
    ref_clip = get_ref_clip(wav)
    return ProcessedAudio(wav=wav, ref_clip=ref_clip,
                          ref_mel=mel_spectrogram(ref_clip),
                          duration=wav.size / target_sr,
                          sample_rate=target_sr)

"""Mel spectrogram of the reference clip, with the reference's numeric
contract.

The port's own copy of the NumPy path of ``rwkv_tts_tpu/ops/mel.py``; it
runs on the host, as in the JAX package. n_mels 128, n_fft 1024, hop 320,
symmetric Hann window of 1024, centre padding of n_fft/2 zeros, magnitude
spectrum (power 1), HTK mel scale with Slaney area normalization
2/(f_hi − f_lo), fmin 10 Hz, fmax 8000 Hz, linear output (reference
src/tts_pipeline_fixes.rs:12-79). An rFFT stands in for the reference's
O(N²) DFT loop: the same math.
"""

from __future__ import annotations

import functools

import numpy as np

N_MELS = 128
N_FFT = 1024
HOP_LENGTH = 320
WIN_LENGTH = 1024
SAMPLE_RATE = 16000
FMIN = 10.0
FMAX = 8000.0


def hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels=N_MELS, n_fft=N_FFT, sample_rate=SAMPLE_RATE,
                   fmin=FMIN, fmax=FMAX) -> np.ndarray:
    """Triangular filters on the HTK mel scale with Slaney 2/(Δf) area
    normalization, evaluated on bin indices as the reference does
    (tts_pipeline_fixes.rs:105-159). Returns [n_mels, n_fft//2+1] f32."""
    n_freqs = n_fft // 2 + 1
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bin_pts = hz_pts * n_fft / sample_rate

    fb = np.zeros((n_mels, n_freqs), np.float64)
    k = np.arange(n_freqs, dtype=np.float64)
    for m in range(1, n_mels + 1):
        left, center, right = bin_pts[m - 1], bin_pts[m], bin_pts[m + 1]
        up = ((k - left) / (center - left) if center > left
              else np.zeros_like(k))
        down = ((right - k) / (right - center) if right > center
                else np.zeros_like(k))
        tri = np.where((k >= left) & (k <= right),
                       np.where(k <= center, up, down), 0.0)
        fb[m - 1] = tri * (2.0 / (hz_pts[m + 1] - hz_pts[m - 1]))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def hann_window(n=WIN_LENGTH) -> np.ndarray:
    """Symmetric Hann as the reference builds it (2πi/(n−1))."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / (n - 1)))).astype(np.float32)


def mel_spectrogram(wav: np.ndarray) -> np.ndarray:
    """wav [T] float32 → mel [128, n_frames] float32 (linear magnitude);
    301 frames for a 6-s (96000-sample) reference clip."""
    wav = np.asarray(wav, dtype=np.float32)
    pad = N_FFT // 2
    padded = np.concatenate([np.zeros(pad, np.float32), wav,
                             np.zeros(pad, np.float32)])
    n = padded.shape[0]
    n_frames = 1 if n <= N_FFT else (n - N_FFT) // HOP_LENGTH + 1
    idx = (np.arange(n_frames)[:, None] * HOP_LENGTH
           + np.arange(N_FFT)[None, :])
    # a short final frame is zero-filled past the end, as the reference does
    frames = (np.where(idx < n, padded[np.minimum(idx, n - 1)], 0.0)
              * hann_window()[None, :])
    spec = np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)
    return (spec @ mel_filterbank().T).T.astype(np.float32)

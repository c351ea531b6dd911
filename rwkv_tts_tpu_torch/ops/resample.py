"""Audio resampling for the reference-audio front end.

The port's own copy of ``rwkv_tts_tpu/ops/resample.py``: windowed-sinc
polyphase resampling at the exact rational ratio (``scipy.signal.upfirdn``),
a Blackman-Harris-windowed sinc with cutoff 0.95·π/max(up, down) and
sinc_len·max(up, down) taps, the design family and quality point of the
reference's rubato SincFixedIn (src/ref_audio_utilities.rs:532-576). It runs
on the host in float64, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import signal

SINC_LEN = 256
F_CUTOFF = 0.95


def _blackman_harris(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    x = 2.0 * np.pi * i / (n - 1)
    return (0.35875 - 0.48829 * np.cos(x) + 0.14128 * np.cos(2 * x)
            - 0.01168 * np.cos(3 * x))


def _design_filter(up: int, down: int) -> np.ndarray:
    m = max(up, down)
    half = (SINC_LEN * m) // 2
    n = 2 * half + 1
    t = (np.arange(n, dtype=np.float64) - half) / m
    h = F_CUTOFF * np.sinc(F_CUTOFF * t) * _blackman_harris(n)
    # DC gain `up`: compensates upfirdn's zero-stuffing
    return h / h.sum() * up


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Resample mono float audio between integer rates → float32."""
    if orig_sr == target_sr:
        return np.asarray(audio, np.float32)
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    h = _design_filter(up, down)
    out = signal.upfirdn(h, np.asarray(audio, np.float64), up=up, down=down)
    # trim the filter's group delay to whole output samples and cut to the
    # rounded expected length
    delay = (len(h) - 1) // 2
    start = delay // down
    n_out = int(np.ceil(len(audio) * up / down))
    out = out[start:start + n_out]
    if len(out) < n_out:
        out = np.pad(out, (0, n_out - len(out)))
    return out.astype(np.float32)

"""Codec weight resolution: find and load BiCodec and wav2vec2 weights from
a model directory, preferring the native modules, falling back to the
reference's exported graphs, and failing loudly when nothing real is found.

Port of ``rwkv_tts_tpu/models/codec_loader.py``. Resolution order (the
reference loads exactly ``BiCodecTokenize.onnx``, ``BiCodecDetokenize.onnx``
and ``wav2vec2-large-xlsr-53.onnx``, bin/server.rs:1074-1198):

  BiCodec:
    1. a torch-style state dict (BiCodec/model.safetensors,
       BiCodec.safetensors, bicodec.{safetensors,pt,bin}) →
       ``convert.load_bicodec_weights`` → the native modules;
    2. the two ONNX exports → ``models/onnx_graph`` (``OnnxBiCodec``), the
       reference's codec by construction;
    with both present, the native import is cross-validated against the
    graphs on a speech-like fixture, and a mismatch serves the graphs.
  wav2vec2:
    1. a HF state dict (wav2vec2.safetensors etc.) →
       ``convert.load_wav2vec2_weights``;
    2. wav2vec2-large-xlsr-53.onnx: its initializers when they keep the HF
       names, else the graph itself (``OnnxWav2Vec2``; the export bakes in
       the (11, 14, 16) hidden-state mean).

A missing codec raises ``FileNotFoundError`` unless ``allow_random``; then
random weights are served and an ERROR is logged (dev and tests only: a
random codec turns speech into noise). Every path loads onto ``device``,
and the timings of each step are logged.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import BiCodecConfig, Wav2Vec2Config
from ..utils.device import resolve_device

log = logging.getLogger(__name__)

BICODEC_STATE_DICTS = (
    "BiCodec/model.safetensors", "BiCodec.safetensors",
    "bicodec.safetensors", "BiCodec/pytorch_model.bin",
    "bicodec.pt", "bicodec.bin",
)
BICODEC_ONNX = ("BiCodecTokenize.onnx", "BiCodecDetokenize.onnx")
W2V_STATE_DICTS = (
    "wav2vec2-large-xlsr-53/model.safetensors", "wav2vec2.safetensors",
    "wav2vec2-large-xlsr-53.safetensors", "wav2vec2.pt", "wav2vec2.bin",
)
W2V_ONNX = "wav2vec2-large-xlsr-53.onnx"


def _first_existing(base: str, names) -> Optional[str]:
    for n in names:
        p = os.path.join(base, n)
        if os.path.exists(p):
            return p
    return None


def load_bicodec(codec_dir: str, cfg: Optional[BiCodecConfig] = None,
                 cross_validate: bool = True, device=None):
    """Returns (parameter tree or OnnxBiCodec, cfg), or (None, cfg)."""
    from . import bicodec
    from .convert import load_bicodec_weights, load_state_dict_file

    dev = resolve_device(device)
    cfg = cfg or BiCodecConfig()
    native = None
    sd_path = _first_existing(codec_dir, BICODEC_STATE_DICTS)
    if sd_path:
        t0 = time.perf_counter()
        try:
            native = load_bicodec_weights(load_state_dict_file(sd_path), cfg,
                                          device=dev)
            log.info("BiCodec: native import from %s in %.2f s", sd_path,
                     time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — unmapped names, corrupt
            # or truncated file: the exported graphs below are the
            # fallback, so a bad optional state dict must not stop startup
            log.warning("BiCodec state dict at %s failed to import (%s: "
                        "%s)", sd_path, type(e).__name__, e)
    tok = os.path.join(codec_dir, BICODEC_ONNX[0])
    detok = os.path.join(codec_dir, BICODEC_ONNX[1])
    graphs = None
    if os.path.exists(tok) and os.path.exists(detok):
        t0 = time.perf_counter()
        try:
            graphs = bicodec.OnnxBiCodec(tok, detok, device=dev)
            log.info("BiCodec: ONNX graphs from %s parsed and placed in "
                     "%.2f s", codec_dir, time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — unsupported op, parse error
            log.warning("BiCodec ONNX graphs failed to load: %s", e)

    if native is not None and graphs is not None and cross_validate:
        t0 = time.perf_counter()
        ok = _bicodec_parity(native, graphs, cfg)
        log.info("BiCodec: cross-validation in %.2f s",
                 time.perf_counter() - t0)
        if ok:
            log.info("BiCodec: native import matches the ONNX graphs — "
                     "serving the native fast path")
            return native, cfg
        log.error("BiCodec: native import DIVERGES from the ONNX graphs — "
                  "serving the graphs (ground truth)")
        return graphs, cfg
    if native is not None:
        return native, cfg
    return graphs, cfg


def _speech_fixture(cfg):
    """Speech-shaped parity inputs (feat [1, T, D], mel [1, 128, 301]).

    The load gate decides between a miswired native encode path and the
    exported graphs, so its inputs must make the quantizers behave as on
    real speech (Gaussian noise puts every codebook lookup at a near-tie):

    * mel: a synthetic vowel (a vibrato'd 120 Hz harmonic series shaped by
      three formant resonances, plus breath noise) through the real front
      end's mel (``ops/mel``);
    * feat: wav2vec2-like hidden states, per-frame z-normalized AR(1)
      sequences (ρ = 0.9), temporally correlated as an encoder output is.
    """
    from ..ops.mel import mel_spectrogram

    sr, n = 16000, 96000  # the 6 s reference clip
    rng = np.random.default_rng(7)
    t = np.arange(n) / sr
    f0 = 120.0 * (1.0 + 0.03 * np.sin(2 * np.pi * 4.0 * t))  # vibrato
    phase = 2 * np.pi * np.cumsum(f0) / sr
    formants = ((500.0, 80.0), (1500.0, 120.0), (2500.0, 160.0))
    sig = np.zeros(n)
    for k in range(1, 61):
        fk = k * 120.0
        if fk > 7600.0:
            break
        env = sum(np.exp(-0.5 * ((fk - fc) / bw) ** 2)
                  for fc, bw in formants)
        sig += (env + 0.05) / k * np.sin(k * phase)
    sig += 0.01 * rng.standard_normal(n)                      # breath
    sig *= 0.3 / np.max(np.abs(sig))
    mel = mel_spectrogram(sig.astype(np.float32))[None]       # [1,128,301]
    if mel.shape[1] != cfg.mel_bins:      # tiny test configs: pool bins
        idx = np.linspace(0, mel.shape[1], cfg.mel_bins + 1).astype(int)
        mel = np.stack([mel[:, a:b].mean(axis=1)
                        for a, b in zip(idx[:-1], idx[1:])], axis=1)
    if mel.shape[2] != cfg.ref_mel_frames:
        pos = np.linspace(0, mel.shape[2] - 1, cfg.ref_mel_frames).astype(int)
        mel = mel[:, :, pos]

    T = 50
    feat = np.empty((T, cfg.feat_dim), np.float32)
    x = rng.standard_normal(cfg.feat_dim)
    for i in range(T):
        x = 0.9 * x + np.sqrt(1 - 0.9 ** 2) * rng.standard_normal(cfg.feat_dim)
        feat[i] = x
    feat = (feat - feat.mean()) / (feat.std() + 1e-7)
    return feat[None], mel.astype(np.float32)


def bicodec_parity(native, graphs, cfg) -> Dict[str, Any]:
    """The native import against the graphs, both ways, on the graphs'
    device: the decode waveforms' largest difference (``decode_max_abs``)
    and, when there is a tokenize graph, the share of equal tokens on the
    speech fixture (``semantic_match``, ``global_match``). The encode side
    carries the reconstruction guesses (ECAPA skip wiring, perceiver norm
    placement, FSQ flatten) that only the real export confirms, so decode
    parity alone must not admit the native path. ``error`` names a check
    that failed to run."""
    from . import bicodec

    dev = graphs.device
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.integers(0, cfg.global_codebook,
                                      (1, cfg.num_global_tokens))).to(dev)
    s = torch.from_numpy(rng.integers(0, cfg.semantic_codebook,
                                      (1, 32))).to(dev)
    out: Dict[str, Any] = {}
    try:
        w_native = bicodec.decode(native, g, s, cfg)
        w_onnx = graphs.decode(g, s).reshape(w_native.shape)
    except Exception as e:  # noqa: BLE001 — reported, and the gate fails
        out["error"] = f"decode: {type(e).__name__}: {e}"
        return out
    out["decode_max_abs"] = float((w_native - w_onnx).abs().max())
    if graphs.tok is None:
        return out
    feat, mel = _speech_fixture(cfg)
    try:
        sem_n, glob_n = bicodec.encode(native, feat, mel, cfg, device=dev)
        sem_o, glob_o = graphs.encode(feat, mel)
    except Exception as e:  # noqa: BLE001 — reported, and the gate fails
        out["error"] = f"encode: {type(e).__name__}: {e}"
        return out
    sem_n, glob_n, sem_o, glob_o = (x.reshape(-1).cpu().numpy() for x in
                                    (sem_n, glob_n, sem_o, glob_o))
    if sem_n.shape != sem_o.shape or glob_n.shape != glob_o.shape:
        out["error"] = (f"encode: shape mismatch (semantic {sem_n.shape} vs "
                        f"{sem_o.shape}, global {glob_n.shape} vs "
                        f"{glob_o.shape})")
        return out
    out["semantic_match"] = float(np.mean(sem_n == sem_o)) \
        if sem_n.size else 1.0
    out["global_match"] = float(np.mean(glob_n == glob_o)) \
        if glob_n.size else 1.0
    return out


def _bicodec_parity(native, graphs, cfg, tol=5e-3) -> bool:
    """The load gate over ``bicodec_parity``: decode within ``tol``, and at
    least 90% of the tokens equal on encode (a float reordering can flip an
    argmin at a near-tie; a miswired path agrees at chance level)."""
    r = bicodec_parity(native, graphs, cfg)
    if "decode_max_abs" in r:
        log.info("BiCodec decode native-vs-ONNX max abs err: %.2e",
                 r["decode_max_abs"])
    if "semantic_match" in r:
        log.info("BiCodec encode native-vs-ONNX token match: semantic "
                 "%.1f%%, global %.1f%%", 100 * r["semantic_match"],
                 100 * r["global_match"])
    if "error" in r:
        log.error("BiCodec parity check failed to run: %s", r["error"])
        return False
    if r["decode_max_abs"] >= tol:
        return False
    if "semantic_match" not in r:
        log.warning("BiCodec encode parity skipped (no tokenize graph): "
                    "native encode wiring is UNVERIFIED")
        return True
    return r["semantic_match"] >= 0.9 and r["global_match"] >= 0.9


def load_w2v(codec_dir: str, cfg: Optional[Wav2Vec2Config] = None,
             device=None):
    """Returns (parameter tree or OnnxWav2Vec2, cfg, output layers), or
    (None, …)."""
    from . import wav2vec2
    from .convert import (load_state_dict_file, load_wav2vec2_weights,
                          read_onnx_initializers)

    dev = resolve_device(device)
    cfg = cfg or Wav2Vec2Config()
    sd_path = _first_existing(codec_dir, W2V_STATE_DICTS)
    if sd_path:
        try:
            params = load_wav2vec2_weights(load_state_dict_file(sd_path), cfg,
                                           device=dev)
            log.info("wav2vec2: native import from %s", sd_path)
            return params, cfg, wav2vec2.OUTPUT_LAYERS
        except Exception as e:  # noqa: BLE001 — see load_bicodec: the
            # ONNX fallback below must get its chance
            log.warning("wav2vec2 state dict at %s failed to import (%s: "
                        "%s)", sd_path, type(e).__name__, e)
    onnx_path = os.path.join(codec_dir, W2V_ONNX)
    if os.path.exists(onnx_path):
        t0 = time.perf_counter()
        try:
            # some exports keep the HF parameter names in the initializers
            params = load_wav2vec2_weights(
                read_onnx_initializers(onnx_path), cfg, device=dev)
            log.info("wav2vec2: native import from ONNX initializers")
            return params, cfg, wav2vec2.OUTPUT_LAYERS
        except Exception:  # noqa: BLE001 — not HF-named or unreadable:
            pass           # the graph itself is parsed below
        try:
            graph = wav2vec2.OnnxWav2Vec2(onnx_path, device=dev)
            log.info("wav2vec2: ONNX graph (layer mix baked in) parsed and "
                     "placed in %.2f s", time.perf_counter() - t0)
            return graph, cfg, wav2vec2.OUTPUT_LAYERS
        except Exception as e:  # noqa: BLE001 — unsupported op, parse error
            log.warning("wav2vec2 ONNX graph failed to load: %s", e)
    return None, cfg, wav2vec2.OUTPUT_LAYERS


def load_codecs(codec_dir: str, allow_random: bool = False, device=None
                ) -> Tuple[Any, BiCodecConfig, Any, Wav2Vec2Config, tuple]:
    """Resolve both codecs on ``device``; raise (or, with ``allow_random``,
    serve random weights under an ERROR log) when real weights are
    absent."""
    dev = resolve_device(device)
    bc_params, bc_cfg = load_bicodec(codec_dir, device=dev)
    w2v_params, w2v_cfg, w2v_layers = load_w2v(codec_dir, device=dev)

    missing = [n for n, p in (("BiCodec", bc_params),
                              ("wav2vec2", w2v_params)) if p is None]
    if missing:
        msg = (f"no usable weights for {', '.join(missing)} under "
               f"{codec_dir!r} (looked for torch/safetensors state dicts "
               f"and the ONNX exports). A random codec produces noise, "
               f"not speech.")
        if not allow_random:
            raise FileNotFoundError(
                msg + " Pass allow_random_codec=True only for dev/test.")
        log.error("%s Serving RANDOM codec weights (allow_random_codec).",
                  msg)
        from . import bicodec, wav2vec2
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        if bc_params is None:
            bc_params = bicodec.init_params(bc_cfg, gen, dev)
        if w2v_params is None:
            w2v_params = wav2vec2.init_params(w2v_cfg, gen, dev)
    return bc_params, bc_cfg, w2v_params, w2v_cfg, w2v_layers

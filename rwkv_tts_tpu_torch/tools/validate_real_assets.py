"""First-contact validation of the published model files on the port: the
counterpart of the JAX package's ``tools/validate_real_assets.py``.

The five published files (``webrwkv.safetensors``, ``tokenizer.json`` and
the three ONNX exports, bin/server.rs:1088-1094) are the one command's input
on a machine that has them, or can fetch them; it runs the whole chain
through the port, stage by stage, under the JAX tool's stage names and
report fields, so that the two ``report.json`` files diff key by key:

  1. files_present      presence; the missing files are fetched through
                        ``utils/download.ensure_models`` (``HF_ENDPOINT``,
                        then the mirrors) unless ``--no-download``
  2. lm_shape_class     the safetensors header against the flagship shape
                        (32 layers x 2048, the port's ``RwkvConfig``)
  3. pipeline_load      ``TtsPipeline.from_checkpoints`` (the codec loader's
                        parity gates run inside; the published layout has
                        no BiCodec state dict, so the codecs are served by
                        the exported graphs, ``OnnxBiCodec`` and
                        ``OnnxWav2Vec2``)
  4. normal_synth       a seeded synthesis (tokens and waveform sanity)
  5. cached_speaker_ab  the cached-speaker path against the exact path at
                        the same seed: speaker-token overlap and log-mel
                        distance
  6. zero_shot_synth    zero-shot from a shipped voice (.raf.json)
  7. enroll_roundtrip   WAV → tokens → a clone, through the voice store
  8. parity_capture     the reference-RNG parity engine
                        (``runtime/parity.py``) for seeds 0 and 42:
                        parity_tokens.json, with each stage seed's first
                        ten raw f32 draws, to diff against the Rust server
  9. continuous_replay  the same seeded requests through the static engine
                        and the continuous slot engine: token-identical
 10. streaming_replay   the captured tokens through the windowed streaming
                        vocoder: exact mode reproduces the one-shot
                        detokenize, the latency modes report their largest
                        deviation

``--quick`` stops after normal_synth with an 8-token cap. Besides
``report.json`` and the WAVs, ``--out`` receives ``stage_seconds.json``:
each stage's wall seconds, from the end of the one before.

Exit code 0 when every stage passed. On the card:

    python -m rwkv_tts_tpu_torch.tools.validate_real_assets
        [--model-dir assets/model] [--no-download] [--out DIR]

and on the CPU with ``RWKV_TTS_PLATFORM=cpu`` (or ``main(argv,
device="cpu")``); without a card and without that it raises.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np


def _args(argv):
    ap = argparse.ArgumentParser(
        prog="validate_real_assets", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model-dir", default="assets/model")
    ap.add_argument("--raf-dir", default="assets/raf")
    ap.add_argument("--no-download", action="store_true")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "validate_real_assets"))
    ap.add_argument("--quant-type", default="int8",
                    choices=["none", "int8", "int4", "nf4", "sf4"])
    ap.add_argument("--max-tokens", type=int, default=0,
                    help="cap the decode length (0 = serving default; "
                         "useful to bound CPU smoke runs)")
    ap.add_argument("--quick", action="store_true",
                    help="first-minutes preset: presence + header + load "
                         "+ one 8-token decode + one vocode, then stop")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device=None) -> int:
    import torch

    from ..utils.device import resolve_device

    if device is None:
        from ..server.app import device_from_env
        device = device_from_env()
    dev = resolve_device(device)
    args = _args(argv)
    if args.quick and not args.max_tokens:
        args.max_tokens = 8
    os.makedirs(args.out, exist_ok=True)
    report: Dict[str, dict] = {}
    seconds: Dict[str, float] = {}
    last = [time.perf_counter()]

    def stage(name, ok, **info):
        now = time.perf_counter()
        seconds[name] = now - last[0]
        last[0] = now
        report[name] = {"ok": bool(ok), **info}
        print(f"[{'PASS' if ok else 'FAIL'}] {name}"
              + (f"  {info}" if info else ""), flush=True)
        return ok

    def write():
        for fname, obj in (("report.json", report),
                           ("stage_seconds.json", seconds)):
            with open(os.path.join(args.out, fname), "w") as f:
                json.dump(obj, f, indent=2)

    # 1. presence ---------------------------------------------------------
    from ..utils.download import MODEL_FILES, ensure_models
    missing = ([f for f in MODEL_FILES
                if not os.path.exists(os.path.join(args.model_dir, f))]
               if args.no_download else
               ensure_models(args.model_dir, required=False))
    if not stage("files_present", not missing, missing=missing):
        print("cannot continue without the model files", flush=True)
        write()
        return 1

    # 2. header vs flagship shape ----------------------------------------
    from ..config import EngineConfig, RwkvConfig, TtsArgs
    from ..models.convert import infer_config, read_safetensors_tensors
    lm_path = os.path.join(args.model_dir, "webrwkv.safetensors")
    # the stored types (infer_config reads shapes): no f32 copy of the LM
    tensors = read_safetensors_tensors(lm_path)
    cfg = infer_config(tensors)
    del tensors
    flag = RwkvConfig()
    flagship_ok = (cfg.n_layer, cfg.n_embd) == (flag.n_layer, flag.n_embd)
    stage("lm_shape_class", True, n_layer=cfg.n_layer, n_embd=cfg.n_embd,
          head_size=cfg.head_size, matches_pinned_flagship=flagship_ok)
    if not flagship_ok:
        print("  NOTE: update the port's RwkvConfig defaults "
              "(rwkv_tts_tpu_torch/config.py) to the real shape above",
              flush=True)

    # 3. full pipeline load (codec parity gates run inside) ---------------
    from ..runtime.pipeline import TtsPipeline
    t0 = time.perf_counter()
    kw = {}
    if args.max_tokens:
        kw["engine_cfg"] = EngineConfig(
            prefill_buckets=(64, 128), max_semantic_tokens=args.max_tokens)
    try:
        pipe = TtsPipeline.from_checkpoints(
            lm_path, raf_dir=args.raf_dir, quant_type=args.quant_type,
            codec_dir=args.model_dir, device=dev, **kw)
    except Exception as e:  # noqa: BLE001 — report, don't crash
        stage("pipeline_load", False, error=f"{type(e).__name__}: {e}")
        write()
        return 1
    stage("pipeline_load", True, seconds=round(time.perf_counter() - t0, 1),
          quant=args.quant_type)

    # 4. seeded normal-mode synth -----------------------------------------
    mt = {"max_tokens": args.max_tokens} if args.max_tokens else {}
    res = pipe.synthesize(TtsArgs(text="你好，世界。Hello world.", seed=42,
                                  **mt))
    wav = np.asarray(res.audio)
    min_samples = 16000 if not args.max_tokens else 320 * 2
    ok = (wav.size >= min_samples and np.isfinite(wav).all()
          and 0.01 < float(np.abs(wav).max()) <= 1.0
          and len(res.global_tokens) == 32)
    pipe.save_audio(res, os.path.join(args.out, "normal_seed42.wav"))
    stage("normal_synth", ok, samples=int(wav.size),
          seconds=round(wav.size / res.sample_rate, 2),
          peak=round(float(np.abs(wav).max()), 3), rtf=round(res.rtf, 4),
          semantic_tokens=len(res.semantic_tokens))
    if args.quick:
        write()
        failed = [k for k, v in report.items() if not v["ok"]]
        print(("QUICK PRESET PASSED (presence + header + load + decode + "
               "vocode) — rerun without --quick for the full chain")
              if not failed else f"FAILED stages: {failed}", flush=True)
        return 1 if failed else 0

    # 5. cached-speaker A/B -----------------------------------------------
    # the cached path's 32 speaker tokens condition on properties and seed
    # only, not on the text: the same text and seed through both paths,
    # and the deviation put in numbers
    try:
        res_ca = pipe.synthesize(TtsArgs(text="你好，世界。Hello world.",
                                         seed=42, cached_speaker=True, **mt))
        wc = np.asarray(res_ca.audio)
        pipe.save_audio(res_ca, os.path.join(args.out,
                                             "cached_speaker_seed42.wav"))
        overlap = _token_overlap(res.global_tokens, res_ca.global_tokens)
        meldist = _logmel_l1(wav, wc)
        stage("cached_speaker_ab",
              wc.size >= min_samples and np.isfinite(wc).all()
              and len(res_ca.global_tokens) == 32,
              samples=int(wc.size),
              speaker_token_overlap=overlap,
              logmel_l1=meldist,
              note="A/B cached_speaker_seed42.wav vs normal_seed42.wav: "
                   "same properties/seed, text-free speaker tokens; "
                   "expected bands in docs/PARITY.md (docstring "
                   "deviation)")
    except Exception as e:  # noqa: BLE001
        stage("cached_speaker_ab", False, error=f"{type(e).__name__}: {e}")

    # 6. zero-shot from a shipped reference voice -------------------------
    voices = pipe.voice_store.list()
    if voices:
        res_zs = pipe.synthesize(TtsArgs(text="a cloned voice speaking",
                                         voice_id=voices[0]["id"], **mt))
        wz = np.asarray(res_zs.audio)
        pipe.save_audio(res_zs, os.path.join(args.out, "zero_shot.wav"))
        stage("zero_shot_synth",
              wz.size >= min_samples and np.isfinite(wz).all(),
              voice=voices[0]["name"], samples=int(wz.size))
    else:
        stage("zero_shot_synth", False, error="no shipped voices found")

    # 7. enrollment round trip --------------------------------------------
    ref_wav = os.path.join(args.out, "normal_seed42.wav")
    try:
        feat = pipe.enroll_voice(ref_wav, "validate-enroll", "hello world")
        res_c = pipe.synthesize(TtsArgs(text="enrollment round trip",
                                        voice_id=feat.id, **mt))
        ok = (len(feat.global_tokens) == 32 and len(feat.semantic_tokens) > 0
              and np.isfinite(np.asarray(res_c.audio)).all())
        stage("enroll_roundtrip", ok, global_tokens=len(feat.global_tokens),
              semantic_tokens=len(feat.semantic_tokens))
        pipe.voice_store.delete(feat.id)
    except Exception as e:  # noqa: BLE001
        stage("enroll_roundtrip", False, error=f"{type(e).__name__}: {e}")

    # 8. reference-RNG parity capture -------------------------------------
    try:
        from .. import constants as C
        from ..runtime.parity import ReferenceRngEngine
        from ..utils.rustrng import RustStdRng
        pe = ReferenceRngEngine(pipe.engine)
        text = "parity capture 你好"
        cap = {}
        for seed in (0, 42):
            r = pe.generate(TtsArgs(
                text=text, seed=seed,
                max_tokens=min(args.max_tokens or 64, 64)))
            cap[str(seed)] = {"global": r.global_tokens,
                              "semantic": r.semantic_tokens,
                              "expected_raw_draws": expected_raw_draws(
                                  seed, C, RustStdRng)}
        del pe
        with open(os.path.join(args.out, "parity_tokens.json"), "w") as f:
            json.dump({"text": text, "quant": args.quant_type,
                       "seeds": cap}, f, indent=1)
        stage("parity_capture",
              all(len(v["global"]) == 32 for v in cap.values()),
              note="A/B parity_tokens.json against the Rust server at the "
                   "same checkpoint/text/seed (docs/PARITY.md); rerun with "
                   "--quant-type none for the cleanest comparison")
    except Exception as e:  # noqa: BLE001
        stage("parity_capture", False, error=f"{type(e).__name__}: {e}")

    # 9. continuous-engine replay -----------------------------------------
    # serving runs the continuous slot engine: the same seeded requests
    # through it and through the static engine must give the same tokens
    # on these weights
    try:
        from ..runtime.continuous import ContinuousEngine
        eng = pipe.engine
        cont = ContinuousEngine(eng.params, eng.cfg, eng.engine_cfg,
                                tokenizer=eng.tokenizer, block=16,
                                slots=min(4, eng.engine_cfg.batch_size),
                                device=eng.device)
        try:
            mismatch = []
            for seed in (0, 42):
                a = TtsArgs(text="parity capture 你好", seed=seed,
                            max_tokens=min(args.max_tokens or 64, 64))
                ws = eng.generate(a)
                wc = cont.generate(a, timeout=900.0)
                if (ws.global_tokens, ws.semantic_tokens) != \
                        (wc.global_tokens, wc.semantic_tokens):
                    mismatch.append(seed)
        finally:
            cont.stop()
            # on a card its graphs and their pool go before the vocoder's
            del cont
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        stage("continuous_replay", not mismatch, mismatched_seeds=mismatch,
              note="static engine vs continuous slot engine, same seeds — "
                   "token-identical by contract (runtime/continuous.py)")
    except Exception as e:  # noqa: BLE001
        stage("continuous_replay", False, error=f"{type(e).__name__}: {e}")

    # 10. streaming-vocoder replay ----------------------------------------
    # exact mode must reproduce the one-shot detokenize (the serving
    # stream's claim); the latency modes report their largest deviation
    try:
        from ..models import bicodec
        from ..runtime.streaming import StreamingVocoder
        g = res.global_tokens
        sem = res.semantic_tokens[:128]
        full = bicodec.detokenize(pipe.bicodec_params, g, sem,
                                  pipe.bicodec_cfg,
                                  graphs=pipe.decode_graphs)[0]
        devs = {}
        for mode in ("exact", "low", "ultra", "flash"):
            sv = StreamingVocoder(pipe.bicodec_params, pipe.bicodec_cfg, g,
                                  latency_mode=None if mode == "exact"
                                  else mode, graphs=pipe.decode_graphs)
            parts = []
            for i in range(0, len(sem), 16):
                parts.append(sv.push(sem[i:i + 16]))
            parts.append(sv.push([], flush=True))
            streamed = np.concatenate(parts)
            n = min(len(streamed), len(full))
            devs[mode] = round(
                float(np.max(np.abs(streamed[:n] - full[:n]))), 5)
        ok = devs["exact"] <= 1e-3 and len(streamed) > 0
        stage("streaming_replay", ok, max_abs_dev=devs,
              note="exact-mode windows must reproduce the one-shot "
                   "detokenize; latency modes truncate the prenet "
                   "conditioning tail by design (runtime/streaming.py)")
    except Exception as e:  # noqa: BLE001
        stage("streaming_replay", False, error=f"{type(e).__name__}: {e}")

    write()
    failed = [k for k, v in report.items() if not v["ok"]]
    print(("ALL STAGES PASSED — listen to the WAVs in " + args.out)
          if not failed else f"FAILED stages: {failed}", flush=True)
    return 1 if failed else 0


def expected_raw_draws(seed: int, C, RustStdRng) -> dict:
    """Per stage seed, the first ten raw f32 draws: on the Rust side
    ``StdRng::seed_from_u64(seed + offset)`` and ten ``gen::<f32>()`` must
    print exactly these (offsets: src/rwkv_sampler.rs:265-275)."""
    m64 = (1 << 64) - 1
    draws = {}
    for name, off in (("global", C.GLOBAL_SEED_OFFSET),
                      ("semantic", C.SEMANTIC_SEED_OFFSET)):
        rng = RustStdRng((seed + off) & m64)
        draws[name] = {"stage_seed": (seed + off) & m64,
                       "first_10_f32": [rng.next_f32() for _ in range(10)]}
    return draws


def _token_overlap(a, b) -> float:
    """Multiset overlap of two 32-token speaker (global) code lists:
    |intersection| / 32. Order does not count: BiCodec's global tokens are
    a speaker embedding's FSQ code, not a sequence."""
    from collections import Counter
    ca, cb = Counter(a), Counter(b)
    inter = sum((ca & cb).values())
    return round(inter / max(len(a), 1), 3)


def _logmel_l1(wav_a, wav_b) -> float:
    """Mean |Δ| of log-mel frames over the common length: the cached-
    speaker A/B's spectral distance (enrollment's mel, ``ops/mel.py``)."""
    from ..ops.mel import mel_spectrogram
    n = min(len(wav_a), len(wav_b))
    if n < 1024:
        return float("nan")
    ma = np.log(np.asarray(mel_spectrogram(wav_a[:n])) + 1e-5)
    mb = np.log(np.asarray(mel_spectrogram(wav_b[:n])) + 1e-5)
    return round(float(np.mean(np.abs(ma - mb))), 3)


if __name__ == "__main__":
    sys.exit(main())

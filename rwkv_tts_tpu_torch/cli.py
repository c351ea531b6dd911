"""Command-line interface: offline synthesis, voice enrollment, library ops.

Port of ``rwkv_tts_tpu/cli.py``. The reference is server-only; this CLI
exposes the same pipeline without HTTP for batch/offline jobs:

  python -m rwkv_tts_tpu_torch.cli synth "text to speak" -o out.wav [--seed 42] …
  python -m rwkv_tts_tpu_torch.cli extract ref.wav --name "my voice" [--prompt …]
  python -m rwkv_tts_tpu_torch.cli voices [--raf-dir assets/raf]
  python -m rwkv_tts_tpu_torch.cli rename <voice_id> "new name"
  python -m rwkv_tts_tpu_torch.cli delete <voice_id>
  python -m rwkv_tts_tpu_torch.cli import-voices <src_dir> [--overwrite]

``synth`` and ``extract`` load ``--model-path`` when it exists (a
webrwkv.safetensors file, a prefab, or a model directory; the codecs from
the same directory, ``TtsPipeline.from_checkpoints``), and otherwise build
random weights at the dev widths. Nothing is downloaded. They run on the
CUDA card unless ``RWKV_TTS_PLATFORM=cpu`` selects the CPU. The library
commands need no model.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .config import TtsArgs


def _build_pipeline(args):
    from .runtime.pipeline import TtsPipeline
    from .server.app import build_dev_pipeline, device_from_env
    if os.path.exists(args.model_path):
        return TtsPipeline.from_checkpoints(
            args.model_path, raf_dir=args.raf_dir,
            quant_type=args.quant_type,
            allow_random_codec=args.allow_random_codec,
            device=device_from_env())
    logging.warning("checkpoint %s not found — random weights (dev mode)",
                    args.model_path)
    return build_dev_pipeline(args.raf_dir, device=device_from_env())


def cmd_synth(args) -> int:
    pipe = _build_pipeline(args)
    req = TtsArgs(
        text=args.text, seed=args.seed, voice_id=args.voice_id,
        max_tokens=args.max_tokens,
        zero_shot=bool(args.ref_audio), ref_audio_path=args.ref_audio,
        age=args.age, gender=args.gender, emotion=args.emotion,
        pitch=args.pitch, speed=args.speed,
        cached_speaker=(True if getattr(args, "cached_speaker", False)
                        else None),
    )
    res = pipe.synthesize(req)
    pipe.save_audio(res, args.output)
    print(json.dumps({
        "output": args.output,
        "seconds": round(len(res.audio) / res.sample_rate, 3),
        "rtf": round(res.rtf, 4),
        "semantic_tokens": len(res.semantic_tokens),
        "timings_ms": res.timings_ms,
    }))
    return 0


def cmd_extract(args) -> int:
    pipe = _build_pipeline(args)
    feat = pipe.enroll_voice(args.audio, args.name, args.prompt)
    print(json.dumps({"voice_id": feat.id, "name": feat.name,
                      "duration": feat.audio_duration,
                      "semantic_tokens": len(feat.semantic_tokens)}))
    return 0


def cmd_voices(args) -> int:
    from .runtime.voice_store import VoiceStore
    print(json.dumps(VoiceStore(args.raf_dir).list(), ensure_ascii=False,
                     indent=2))
    return 0


def cmd_rename(args) -> int:
    from .runtime.voice_store import VoiceStore
    feat = VoiceStore(args.raf_dir).rename(args.voice_id, args.new_name)
    print(json.dumps({"id": feat.id, "name": feat.name}))
    return 0


def cmd_delete(args) -> int:
    from .runtime.voice_store import VoiceStore
    ok = VoiceStore(args.raf_dir).delete(args.voice_id)
    print(json.dumps({"deleted": ok}))
    return 0 if ok else 1


def cmd_import_voices(args) -> int:
    """Migrate a reference server's assets/raf voice library in place —
    the .raf.json schema and SHA-256 scheme are byte-compatible."""
    from .runtime.voice_store import VoiceStore
    report = VoiceStore(args.raf_dir).import_voices(
        args.src_dir, overwrite=args.overwrite)
    print(json.dumps(report, ensure_ascii=False, indent=2))
    return 0 if not report["failed"] else 1


def main(argv=None) -> int:
    # global options live on a parent parser shared by the root AND every
    # subcommand, so both documented orderings parse: `cli --raf-dir X
    # voices` and `cli voices --raf-dir X` (argparse rejects
    # post-subcommand flags defined only on the root). The parent uses
    # SUPPRESS so a subparser's unset options never clobber values parsed
    # before the subcommand; real defaults come from set_defaults.
    SUP = argparse.SUPPRESS
    g = argparse.ArgumentParser(add_help=False)
    g.add_argument("--model-path", default=SUP)
    g.add_argument("--raf-dir", default=SUP)
    g.add_argument("--quant-type",
                   choices=["none", "int8", "int4", "nf4", "sf4"],
                   default=SUP)
    g.add_argument("--allow-random-codec", action="store_true", default=SUP,
                   help="proceed with random codec weights when the real "
                        "BiCodec/wav2vec2 files are missing (dev only: "
                        "output is noise, not speech)")
    p = argparse.ArgumentParser("rwkv-tts-torch", parents=[g])
    # real defaults applied POST-parse (below): parents share action
    # objects, so set_defaults here would rewrite the shared SUPPRESS
    # defaults and the subparser pass would clobber values parsed before
    # the subcommand
    GLOBAL_DEFAULTS = dict(model_path="assets/model/webrwkv.safetensors",
                           raf_dir="assets/raf", quant_type="none",
                           allow_random_codec=False)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_parser(name, **kw):
        return sub.add_parser(name, parents=[g], **kw)

    s = add_parser("synth", help="synthesize text to an audio file")
    s.add_argument("text")
    s.add_argument("-o", "--output", default="out.wav")
    s.add_argument("--seed", type=int, default=None)
    s.add_argument("--voice-id", default=None)
    s.add_argument("--ref-audio", default=None,
                   help="clone directly from a WAV/MP3 file (zero-shot, "
                        "no prior enrollment)")
    s.add_argument("--max-tokens", type=int, default=8000)
    s.add_argument("--age", default="youth-adult")
    s.add_argument("--gender", default="female")
    s.add_argument("--emotion", default="NEUTRAL")
    s.add_argument("--pitch", default="medium_pitch")
    s.add_argument("--speed", default="medium")
    s.add_argument("--cached-speaker", action="store_true",
                   help="reuse cached speaker tokens per (properties, "
                        "seed) and skip the 32-step speaker stage")
    s.set_defaults(fn=cmd_synth)

    e = add_parser("extract", help="enroll a voice from reference audio")
    e.add_argument("audio")
    e.add_argument("--name", required=True)
    e.add_argument("--prompt", default="")
    e.set_defaults(fn=cmd_extract)

    v = add_parser("voices", help="list the voice library")
    v.set_defaults(fn=cmd_voices)

    d = add_parser("delete", help="delete a voice")
    d.add_argument("voice_id")
    d.set_defaults(fn=cmd_delete)

    rn = add_parser("rename", help="rename a voice (library parity: "
                                   "voice_feature_manager.rs:336-369)")
    rn.add_argument("voice_id")
    rn.add_argument("new_name")
    rn.set_defaults(fn=cmd_rename)

    iv = add_parser("import-voices",
                        help="import a reference server's raf directory")
    iv.add_argument("src_dir")
    iv.add_argument("--overwrite", action="store_true")
    iv.set_defaults(fn=cmd_import_voices)

    args = p.parse_args(argv)
    for k, v in GLOBAL_DEFAULTS.items():
        if not hasattr(args, k):
            setattr(args, k, v)
    logging.basicConfig(level=logging.INFO)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""The port's CLI (``rwkv_tts_tpu_torch.cli``) against tests/test_cli.py's
contract and the JAX CLI's output: the library commands run without a
model and print what the JAX CLI prints; ``synth`` and ``extract`` build
the server's dev pipeline on the CPU under ``RWKV_TTS_PLATFORM=cpu``, load
a checkpoint on disk (and refuse an unreadable one) and, with no card and
no CPU knob, refuse to run, as ``python -m rwkv_tts_tpu_torch.server.app``
does."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch.audio import mp3
from rwkv_tts_tpu_torch.audio.io import encode_wav_16bit, read_audio_file
from rwkv_tts_tpu_torch.cli import main
from rwkv_tts_tpu_torch.runtime.voice_store import VoiceStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are small: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_voices_and_delete(tmp_path, capsys):
    store = VoiceStore(str(tmp_path))
    feat = store.save("cli voice", "prompt", [1] * 32, [5, 6], 1.0, 16000)

    assert main(["--raf-dir", str(tmp_path), "voices"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out[0]["id"] == feat.id

    assert main(["--raf-dir", str(tmp_path), "delete", feat.id]) == 0
    assert json.loads(capsys.readouterr().out) == {"deleted": True}
    assert main(["--raf-dir", str(tmp_path), "delete", feat.id]) == 1


def test_library_commands_print_what_the_jax_cli_prints(tmp_path, capsys):
    pytest.importorskip("jax")
    from rwkv_tts_tpu.cli import main as jmain

    src = tmp_path / "src"
    VoiceStore(str(src)).save("imported", "p", [2] * 32, [7], 0.5, 16000)
    outs = []
    for i, fn in enumerate((jmain, main)):
        lib = tmp_path / f"lib{i}"
        feat = VoiceStore(str(lib)).save("声音", "提示", [1] * 32, [5, 6],
                                         1.0, 16000)
        run = []
        for argv in (["voices", "--raf-dir", str(lib)],
                     ["--raf-dir", str(lib), "rename", feat.id, "新名字"],
                     ["--raf-dir", str(lib), "import-voices", str(src)],
                     ["--raf-dir", str(lib), "delete", "missing"]):
            rc = fn(argv)
            run.append((rc, json.loads(capsys.readouterr().out)))
        outs.append(run)
    (jrun, prun) = outs
    assert [rc for rc, _ in prun] == [rc for rc, _ in jrun] == [0, 0, 0, 1]
    for (_, j), (_, p) in zip(jrun, prun):
        assert type(p) is type(j)
    assert [v["name"] for v in prun[0][1]] == [v["name"] for v in jrun[0][1]]
    assert prun[1][1]["name"] == jrun[1][1]["name"] == "新名字"
    assert prun[2][1] == jrun[2][1] and prun[3][1] == jrun[3][1]


def test_synth_and_extract_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``synth`` writes a 16 kHz WAV (and an MP3 where libmp3lame and
    libmpg123 load) of 320 samples per semantic token; ``extract`` enrolls
    a voice from a WAV clip into the store."""
    monkeypatch.setenv("RWKV_TTS_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    raf = str(tmp_path / "raf")
    outs = ["out.wav"] + (["out.mp3"] if mp3.lame_available()
                          and mp3.mpg123_available() else [])
    for name in outs:
        assert main(["--raf-dir", raf, "synth", "hello there", "-o", name,
                     "--max-tokens", "6", "--seed", "3"]) == 0
        rep = json.loads(capsys.readouterr().out)
        assert rep["output"] == name and rep["semantic_tokens"] <= 6
        samples, sr, ch = read_audio_file(str(tmp_path / name))
        assert sr == 16000 and ch == 1 and np.all(np.isfinite(samples))
        if name.endswith(".wav"):
            assert len(samples) == rep["semantic_tokens"] * 320
            assert rep["seconds"] == round(len(samples) / 16000, 3)
    rng = np.random.default_rng(0)
    clip = tmp_path / "ref.wav"
    clip.write_bytes(encode_wav_16bit(
        rng.normal(0, 0.2, 16000 * 2).astype(np.float32), 16000))
    assert main(["--raf-dir", raf, "extract", str(clip), "--name", "mine",
                 "--prompt", "words"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["name"] == "mine" and rep["semantic_tokens"] > 0
    assert VoiceStore(raf).load(rep["voice_id"]).prompt_text == "words"


def test_model_path_and_device_rules(tmp_path, monkeypatch, capsys):
    """A checkpoint on disk that is neither safetensors nor a prefab raises
    (no silent random weights); a real one is loaded and synthesizes; with
    no card and no CPU knob the pipeline is refused."""
    ckpt = tmp_path / "model.safetensors"
    ckpt.write_bytes(b"\0" * 8)
    monkeypatch.setenv("RWKV_TTS_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="neither a safetensors file nor a "
                                         "readable web-rwkv prefab"):
        main(["--model-path", str(ckpt), "--raf-dir", str(tmp_path),
              "synth", "x"])
    from rwkv_tts_tpu_torch.config import BiCodecConfig, Wav2Vec2Config
    from rwkv_tts_tpu_torch.models import codec_loader
    from test_convert import make_rwkv7_checkpoint, write_safetensors

    # a 2 × 128 checkpoint with the real vocabulary; random codecs at small
    # shapes (the directory holds none)
    write_safetensors(str(ckpt), make_rwkv7_checkpoint(V=77923))
    monkeypatch.setattr(codec_loader, "BiCodecConfig", BiCodecConfig.tiny)
    monkeypatch.setattr(codec_loader, "Wav2Vec2Config", lambda: (
        Wav2Vec2Config(num_layers=1, hidden_size=32, num_heads=2,
                       ffn_size=32, conv_dims=(16,) * 7)))
    out = tmp_path / "x.wav"
    assert main(["--model-path", str(ckpt), "--raf-dir", str(tmp_path),
                 "--allow-random-codec", "synth", "hello", "-o", str(out),
                 "--seed", "1", "--max-tokens", "4"]) == 0
    assert json.loads(capsys.readouterr().out)["output"] == str(out)
    assert out.stat().st_size > 44
    monkeypatch.delenv("RWKV_TTS_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="RWKV_TTS_PLATFORM=cpu"):
        main(["--model-path", str(tmp_path / "absent"), "--raf-dir",
              str(tmp_path), "synth", "x"])


def test_server_without_a_card_or_the_cpu_knob_raises(tmp_path):
    """``python -m rwkv_tts_tpu_torch.server.app`` with no card and no
    ``RWKV_TTS_PLATFORM=cpu`` raises instead of serving on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    env.pop("RWKV_TTS_PLATFORM", None)
    out = subprocess.run(
        [sys.executable, "-m", "rwkv_tts_tpu_torch.server.app", "--port",
         "0", "--raf-dir", str(tmp_path / "raf"), "--no-download"],
        cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "RWKV_TTS_PLATFORM=cpu" in out.stderr
    assert "serving on" not in out.stderr

"""Voice cloning on the port against the JAX pipeline
(``TtsPipeline(use_pallas=False)``) on the CPU, on the same seeded WAV
files and bridged weights: the LM at the goldens shape (2 layers × 128),
wav2vec2 at 4 layers × 64 and ``BiCodecConfig.tiny(feat_dim=64)``. (The
semantic codebook stays at 8192 here, unlike the encode tests' 128: the
vocoder must take every semantic id the LM can emit.)

Extraction gives the same global and semantic tokens; the voice chain falls
down as the JAX pipeline's does (tests/test_codecs.py:324-385); zero-shot
synthesis by reference audio and by voice_id emits the same tokens, with
waveforms within the BiCodec chain bound of test_torch_bicodec.py. Also
the chip smoke script's cloning phase at these shapes."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.audio.io import encode_wav_16bit
from rwkv_tts_tpu_torch.config import (BiCodecConfig, EngineConfig,
                                       RwkvConfig, TtsArgs, Wav2Vec2Config)
from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline
from rwkv_tts_tpu_torch.runtime.voice_store import VoiceStore
from rwkv_tts_tpu_torch.utils import bridge

from test_torch_bicodec import chain_close


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are small: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LM_CFG = RwkvConfig(**chip_smoke.GOLDENS_CFG)
W2V = dict(num_layers=4, hidden_size=64, num_heads=4, ffn_size=128,
           conv_dims=(32,) * 7)
W2V_LAYERS = (2, 3)
ENGINE = dict(prefill_buckets=(64, 128), max_semantic_tokens=16)
SHIPPED = Path(__file__).resolve().parent.parent / "assets" / "raf"
VOICE_IDS = sorted(p.name[:-len(".raf.json")]
                   for p in SHIPPED.glob("*.raf.json"))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Two seeded reference clips (one at 24 kHz, so resampling runs) and a
    voice directory holding the shipped voices."""
    d = tmp_path_factory.mktemp("cloning")
    for i, sr in enumerate((24000, 16000)):
        clip = chip_smoke.reference_clip(100 + i, sr, 3.0 + i)
        (d / f"ref{i}.wav").write_bytes(encode_wav_16bit(clip, sr))
    (d / "raf").mkdir()
    for vid in VOICE_IDS:
        shutil.copy(SHIPPED / f"{vid}.raf.json", d / "raf")
    return d


@pytest.fixture(scope="module")
def jax_weights():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import BiCodecConfig as JB
    from rwkv_tts_tpu.config import RwkvConfig as JR
    from rwkv_tts_tpu.config import Wav2Vec2Config as JW
    from rwkv_tts_tpu.models import bicodec, rwkv7, wav2vec2

    return (rwkv7.init_params(JR(**chip_smoke.GOLDENS_CFG),
                              jax.random.PRNGKey(1234)),
            bicodec.init_params(JB.tiny(feat_dim=64), jax.random.PRNGKey(1)),
            wav2vec2.init_params(JW(**W2V), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jpipe(jax_weights, workdir):
    from rwkv_tts_tpu.config import BiCodecConfig as JB
    from rwkv_tts_tpu.config import EngineConfig as JE
    from rwkv_tts_tpu.config import RwkvConfig as JR
    from rwkv_tts_tpu.config import Wav2Vec2Config as JW
    from rwkv_tts_tpu.runtime.pipeline import TtsPipeline as JPipeline
    from rwkv_tts_tpu.runtime.voice_store import VoiceStore as JStore

    lm, bc, w2v = jax_weights
    return JPipeline(lm, JR(**chip_smoke.GOLDENS_CFG), bc,
                     JB.tiny(feat_dim=64), w2v, JW(**W2V),
                     voice_store=JStore(str(workdir / "raf")),
                     engine_cfg=JE(**ENGINE), use_pallas=False,
                     w2v_output_layers=W2V_LAYERS)


def make_pipe(jax_weights, workdir, with_w2v=True):
    lm, bc, w2v = jax_weights
    return TtsPipeline(
        bridge.rwkv7_params(lm, "cpu"), LM_CFG,
        bridge.bicodec_params(bc, "cpu"), BiCodecConfig.tiny(feat_dim=64),
        bridge.wav2vec2_params(w2v, "cpu") if with_w2v else None,
        Wav2Vec2Config(**W2V), voice_store=VoiceStore(str(workdir / "raf")),
        engine_cfg=EngineConfig(**ENGINE), w2v_output_layers=W2V_LAYERS,
        device="cpu")


@pytest.fixture(scope="module")
def pipe(jax_weights, workdir):
    return make_pipe(jax_weights, workdir)


def jargs(r):
    from rwkv_tts_tpu.config import TtsArgs as JArgs
    return JArgs(**{f: getattr(r, f) for f in r.__dataclass_fields__})


@pytest.mark.parametrize("clip", [0, 1])
def test_extract_voice_tokens_matches_jax(pipe, jpipe, workdir, clip):
    path = str(workdir / f"ref{clip}.wav")
    g, s, dur = pipe.extract_voice_tokens(path)
    jg, js, jdur = jpipe.extract_voice_tokens(path)
    assert len(g) == 32 and len(s) > 0
    assert (g, s) == (jg, js)
    assert dur == jdur


def test_voice_chain_falls_down_as_jax_does(pipe, jpipe, workdir, caplog):
    """The cases of tests/test_codecs.py:324-385 on both pipelines."""
    wav = str(workdir / "ref0.wav")
    bad = workdir / "bad.wav"
    bad.write_bytes(b"not audio at all" * 8)
    mp3 = workdir / "ref.mp3"
    mp3.write_bytes(b"ID3" + bytes(200))
    cases = {
        "bad id + direct tokens": TtsArgs(text="x", voice_id="missing",
                                          ref_global_tokens=[3] * 32),
        "direct tokens, user seed": TtsArgs(text="x", seed=777,
                                            ref_global_tokens=[3] * 32),
        "bad id alone": TtsArgs(text="x", voice_id="missing", seed=5),
        "shipped voice": TtsArgs(text="x", voice_id=VOICE_IDS[0], seed=5),
        "reference audio": TtsArgs(text="x", ref_audio_path=wav, seed=9),
        "bad audio file": TtsArgs(text="x", ref_audio_path=str(bad), seed=9),
        "missing file": TtsArgs(text="x", ref_audio_path=str(
            workdir / "missing.wav"), seed=2),
        "corrupt mp3 file": TtsArgs(text="x", ref_audio_path=str(mp3),
                                         seed=2),
    }
    with caplog.at_level("WARNING"):
        for name, args in cases.items():
            got, want = pipe.resolve_voice(args), jpipe.resolve_voice(
                jargs(args))
            assert (got.zero_shot, got.seed) == (want.zero_shot, want.seed), \
                name
            assert list(got.ref_global_tokens or []) == \
                list(want.ref_global_tokens or []), name
            assert list(got.ref_semantic_tokens or []) == \
                list(want.ref_semantic_tokens or []), name
            assert got.prompt_text == want.prompt_text, name
    assert "falling back down the voice chain" in caplog.text
    clone = pipe.resolve_voice(cases["reference audio"])
    assert clone.zero_shot and clone.seed == 0 and \
        len(clone.ref_global_tokens) == 32


def test_one_extraction_for_two_requests(jax_weights, workdir):
    pipe = make_pipe(jax_weights, workdir)
    wav = str(workdir / "ref1.wav")
    calls = []
    real = pipe.extract_voice_tokens
    pipe.extract_voice_tokens = lambda p: calls.append(p) or real(p)
    a1 = pipe.resolve_voice(TtsArgs(text="x", ref_audio_path=wav, seed=9))
    a2 = pipe.resolve_voice(TtsArgs(text="y", ref_audio_path=wav))
    assert a1.ref_global_tokens == a2.ref_global_tokens
    assert a1.ref_semantic_tokens == a2.ref_semantic_tokens
    assert calls == [wav], "the second request must hit the checksum cache"


def test_without_wav2vec2_reference_audio_falls_down(jax_weights, workdir):
    pipe = make_pipe(jax_weights, workdir, with_w2v=False)
    got = pipe.resolve_voice(TtsArgs(text="x", seed=4,
                                     ref_audio_path=str(workdir / "ref0.wav")))
    assert not got.zero_shot and got.seed == 4


def test_cloning_batch_matches_jax(pipe, jpipe, workdir):
    """Zero-shot by reference audio (both clips) and by voice_id, in one
    batch with a property-controlled request: the same tokens as the JAX
    pipeline; waveforms within the chain bound."""
    reqs = [TtsArgs(text="clone this voice", ref_audio_path=str(
                workdir / "ref0.wav"), max_tokens=12, seed=3),
            TtsArgs(text="你好，克隆的声音", ref_audio_path=str(
                workdir / "ref1.wav"), max_tokens=10),
            TtsArgs(text="an enrolled voice speaks", voice_id=VOICE_IDS[1],
                    max_tokens=12),
            TtsArgs(text="properties only", seed=11, max_tokens=8)]
    want = jpipe.synthesize_batch([jargs(r) for r in reqs])
    got = pipe.synthesize_batch(reqs)
    for g, w in zip(got, want):
        assert g.global_tokens == w.global_tokens
        assert g.semantic_tokens == w.semantic_tokens
        assert g.audio.shape == w.audio.shape
        assert g.audio.shape == (len(g.semantic_tokens) * 320,) or \
            (not g.semantic_tokens and g.audio.shape == (16000,))
        chain_close(g.audio, w.audio)
    store = VoiceStore(str(workdir / "raf"))
    assert got[2].global_tokens == store.get_voice_tokens(VOICE_IDS[1])[0]
    assert got[0].global_tokens == \
        pipe.extract_voice_tokens_cached(str(workdir / "ref0.wav"))[0]


def test_synthesize_is_a_batch_of_one(pipe, workdir):
    args = TtsArgs(text="one request", voice_id=VOICE_IDS[0], max_tokens=6)
    one = pipe.synthesize(args)
    batch = pipe.synthesize_batch([args])[0]
    assert one.global_tokens == batch.global_tokens
    assert one.semantic_tokens == batch.semantic_tokens
    np.testing.assert_array_equal(one.audio, batch.audio)


def test_chip_smoke_cloning_at_small_shapes():
    """chip_smoke.py's cloning phase and its checks on the CPU: 8 prompts
    of 100-220 text tokens pad to the T = 256 bucket in one prefill chunk,
    3 clips are extracted once each for 6 requests."""
    out = chip_smoke.cloning(
        torch, LM_CFG, BiCodecConfig.tiny(feat_dim=64), Wav2Vec2Config(**W2V),
        "cpu", max_tokens=4,
        engine_cfg=EngineConfig(prefill_buckets=(64, 128, 256),
                                max_semantic_tokens=8),
        w2v_layers=W2V_LAYERS, warmup=False)
    assert len(out["results"]) == 8
    assert 135 <= out["longest_prompt"] <= 256
    assert out["counters"]["prefill_chunks"] == 1
    assert len(out["extract_ms"]) == 3
    assert all(len(r.semantic_tokens) == 4 for r in out["results"])

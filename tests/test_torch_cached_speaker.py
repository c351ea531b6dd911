"""The cached-speaker path of the port (mirrors
``tests/test_cached_speaker.py`` without its HTTP cases): a
property-controlled request reuses 32 speaker tokens cached by (properties,
seed) and runs the zero-shot chain, skipping the global stage. Held against
the JAX engine's ``generate_speaker_tokens`` and the JAX pipeline on the
same weights."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import (BiCodecConfig, EngineConfig,
                                       RwkvConfig, TtsArgs)
from rwkv_tts_tpu_torch.models import bicodec
from rwkv_tts_tpu_torch.runtime.continuous import ContinuousEngine
from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline
from rwkv_tts_tpu_torch.runtime.streaming import stream_synthesize
from rwkv_tts_tpu_torch.runtime.voice_store import VoiceStore
from rwkv_tts_tpu_torch.utils import bridge


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LM_CFG = RwkvConfig(**chip_smoke.GOLDENS_CFG)
ECFG = EngineConfig(prefill_buckets=(32, 64), max_semantic_tokens=16,
                    batch_size=2)
BC_CFG = BiCodecConfig.tiny()


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    return TtsPipeline(
        bridge.rwkv7_params(chip_smoke.goldens_params(LM_CFG, 1234), "cpu"),
        LM_CFG, bicodec.init_params(BC_CFG, device="cpu"), BC_CFG,
        voice_store=VoiceStore(str(tmp_path_factory.mktemp("raf"))),
        engine_cfg=ECFG, device="cpu")


def test_speaker_tokens_deterministic_and_in_range(pipe):
    a = TtsArgs(text="x", gender="male", seed=5)
    t1 = pipe.engine.generate_speaker_tokens(a, 5)
    assert t1 == pipe.engine.generate_speaker_tokens(a, 5)
    assert len(t1) == 32 and all(0 <= t < 4096 for t in t1)
    # another stage seed gives another speaker; the text plays no part
    assert pipe.engine.generate_speaker_tokens(a, 6) != t1
    assert pipe.engine.generate_speaker_tokens(
        dataclasses.replace(a, text="something else entirely"), 5) == t1


@pytest.mark.parametrize("props,seed", [
    (dict(), 5), (dict(gender="male", emotion="HAPPY"), 6),
    (dict(age="child", pitch="high_pitch", speed="very_fast"), 123456)])
def test_speaker_tokens_match_jax(pipe, props, seed):
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import EngineConfig as JE
    from rwkv_tts_tpu.config import RwkvConfig as JC
    from rwkv_tts_tpu.config import TtsArgs as JArgs
    from rwkv_tts_tpu.models import rwkv7 as J
    from rwkv_tts_tpu.runtime.engine import TtsEngine as JEngine

    jcfg = JC(**chip_smoke.GOLDENS_CFG)
    jeng = JEngine(J.init_params(jcfg, jax.random.PRNGKey(1234)), jcfg,
                   JE(prefill_buckets=(32, 64), max_semantic_tokens=16,
                      batch_size=2), use_pallas=False)
    want = jeng.generate_speaker_tokens(JArgs(text="x", **props), seed)
    got = pipe.engine.generate_speaker_tokens(TtsArgs(text="y", **props),
                                              seed)
    assert got == want


def test_cache_keying(pipe, monkeypatch):
    base = TtsArgs(text="hello", seed=11, cached_speaker=True)
    g1 = pipe.get_cached_speaker(base)
    assert pipe.get_cached_speaker(
        dataclasses.replace(base, text="other")) == g1     # not the text
    assert pipe.get_cached_speaker(
        dataclasses.replace(base, seed=12)) != g1          # the seed
    assert pipe.get_cached_speaker(
        dataclasses.replace(base, gender="male")) != g1    # the properties
    # a hit does not call the engine again
    calls = []
    orig = pipe.engine.generate_speaker_tokens
    monkeypatch.setattr(pipe.engine, "generate_speaker_tokens",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    assert pipe.get_cached_speaker(base) == g1 and not calls
    # a caller cannot corrupt the cache through the list it was given
    pipe.get_cached_speaker(base).clear()
    assert pipe.get_cached_speaker(base) == g1


def test_seed_none_is_stable_default_voice(pipe):
    a = TtsArgs(text="a", seed=None, cached_speaker=True, emotion="HAPPY")
    assert pipe.get_cached_speaker(a) == pipe.get_cached_speaker(
        dataclasses.replace(a, text="b"))


def test_resolve_voice_cached_rung(pipe):
    r = pipe.resolve_voice(TtsArgs(text="hi", seed=3, cached_speaker=True))
    assert r.zero_shot is True and len(r.ref_global_tokens) == 32
    assert r.seed == 3                   # the user's seed is kept
    assert r.ref_semantic_tokens == []
    # off by default: a plain request is untouched
    r0 = pipe.resolve_voice(TtsArgs(text="hi", seed=3))
    assert r0.zero_shot is False and not r0.ref_global_tokens
    # the pipeline's default on, an explicit False opts out
    pipe.cached_speaker_default = True
    try:
        r1 = pipe.resolve_voice(TtsArgs(text="hi", seed=3))
        assert r1.zero_shot is True and len(r1.ref_global_tokens) == 32
        r2 = pipe.resolve_voice(TtsArgs(text="hi", seed=3,
                                        cached_speaker=False))
        assert r2.zero_shot is False
    finally:
        pipe.cached_speaker_default = False


def test_voice_id_outranks_cached_speaker(pipe):
    feat = pipe.voice_store.save(
        name="v", prompt_text="p", global_tokens=[1] * 32,
        semantic_tokens=[2, 3], audio_duration=1.0, sample_rate=16000)
    try:
        r = pipe.resolve_voice(TtsArgs(text="hi", voice_id=feat.id,
                                       cached_speaker=True, seed=9))
        assert r.ref_global_tokens == [1] * 32   # the library voice
        assert r.seed == 0                       # cloning forces seed 0
    finally:
        pipe.voice_store.delete(feat.id)
    # direct reference tokens outrank it too
    r = pipe.resolve_voice(TtsArgs(text="hi", ref_global_tokens=[2] * 32,
                                   cached_speaker=True, seed=9))
    assert r.ref_global_tokens == [2] * 32 and r.seed == 0


def test_synthesize_cached_end_to_end(pipe):
    a = TtsArgs(text="cached fast path", seed=21, cached_speaker=True,
                max_tokens=12)
    before = dict(pipe.engine.counters)
    r1 = pipe.synthesize(a)
    # the speaker's 32 global steps ran once, for the cache; the request
    # itself ran the zero-shot chain (no global stage, no TAG_1 step)
    first = pipe.engine.counters["decode_steps"] - before["decode_steps"]
    r2 = pipe.synthesize(a)
    second = pipe.engine.counters["decode_steps"] - before["decode_steps"] \
        - first
    assert first == second + 32
    assert np.isfinite(r1.audio).all() and len(r1.audio) > 0
    assert r1.global_tokens == pipe.get_cached_speaker(a)
    assert r1.semantic_tokens == r2.semantic_tokens
    assert r1.global_tokens == r2.global_tokens
    np.testing.assert_array_equal(r1.audio, r2.audio)


def test_synthesize_cached_matches_jax_pipeline(pipe):
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import BiCodecConfig as JB
    from rwkv_tts_tpu.config import EngineConfig as JE
    from rwkv_tts_tpu.config import RwkvConfig as JC
    from rwkv_tts_tpu.config import TtsArgs as JArgs
    from rwkv_tts_tpu.models import bicodec as JBC
    from rwkv_tts_tpu.models import rwkv7 as J
    from rwkv_tts_tpu.runtime.pipeline import TtsPipeline as JPipeline

    jcfg = JC(**chip_smoke.GOLDENS_CFG)
    jpipe = JPipeline(
        J.init_params(jcfg, jax.random.PRNGKey(1234)), jcfg,
        JBC.init_params(JB.tiny(), jax.random.PRNGKey(0)), JB.tiny(),
        voice_store=None,
        engine_cfg=JE(prefill_buckets=(32, 64), max_semantic_tokens=16,
                      batch_size=2), use_pallas=False)
    kw = dict(text="cached parity", seed=8, cached_speaker=True,
              max_tokens=12, gender="male")
    want = jpipe.synthesize(JArgs(**kw))
    got = pipe.synthesize(TtsArgs(**kw))
    assert got.global_tokens == want.global_tokens
    assert got.semantic_tokens == want.semantic_tokens


def test_assemble_result_accounts_rtf_like_a_batch(pipe):
    from rwkv_tts_tpu_torch.runtime.engine import GenerationResult

    wav = np.zeros(16000, np.float32)
    res = pipe.assemble_result(GenerationResult([1] * 32, [5, 6], 4, 34),
                               wav, {"generate": 300.0, "detokenize": 200.0})
    assert res.rtf == pytest.approx(0.5) and res.sample_rate == 16000
    assert res.semantic_tokens == [5, 6] and res.audio is wav
    assert pipe.assemble_result(GenerationResult([], [], 0, 0), wav[:0],
                                {"generate": 1.0}).rtf == 0.0


def test_streaming_cached_speaker(pipe):
    """The cached speaker rides a stream: resolution happens upstream of
    the continuous engine, the stream runs the zero-shot chain, and the
    audio arrives in chunks in the cached voice."""
    eng = ContinuousEngine(pipe.engine.params, LM_CFG, ECFG, block=8,
                           slots=2, device="cpu")
    try:
        args = pipe.resolve_voice(TtsArgs(text="cached stream", seed=5,
                                          cached_speaker=True,
                                          max_tokens=16))
        assert any(k[-1] == 5 for k in pipe._speaker_cache)
        chunks = list(stream_synthesize(
            eng, pipe.bicodec_params, pipe.bicodec_cfg, args,
            latency_mode="flash", timeout=300.0))
        assert chunks[-1].final and len(chunks) >= 2
        audio = np.concatenate([c.audio for c in chunks])
        want = pipe.engine.generate(args)
        assert audio.shape == (len(want.semantic_tokens) * 320,)
        assert np.isfinite(audio).all()
        assert eng.stats["blocks"] < 1 + 32 // 8   # no global stage ran
    finally:
        eng.stop()


def test_codec_arguments_set_the_codec_config(pipe):
    p2 = TtsPipeline(pipe.engine.params, LM_CFG, pipe.bicodec_params, BC_CFG,
                     engine_cfg=ECFG, device="cpu", codec_dtype="bfloat16",
                     codec_conv_impl="mxu_fused")
    assert p2.bicodec_cfg.conv_impl == "mxu_fused"
    assert p2.bicodec_cfg.dtype == "bfloat16"
    assert p2.bicodec_params["wavegen"]["in_w"].dtype == torch.bfloat16
    assert p2.bicodec_params["quantizer"]["codebook"].dtype == torch.float32
    assert pipe.bicodec_params["wavegen"]["in_w"].dtype == torch.float32

"""The port's TtsPipeline against the JAX pipeline on the CPU: the same
tokens, and waveforms within the BiCodec chain bound of
test_torch_bicodec.py, for a mixed batch of property-controlled and
direct-token requests; plus the port's voice chain, WAV writer and the
chip smoke script's main path at tiny shapes."""

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import (BiCodecConfig, EngineConfig,
                                       RwkvConfig, TtsArgs)
from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline
from rwkv_tts_tpu_torch.utils import bridge

from test_torch_bicodec import chain_close


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LM_CFG = RwkvConfig(**chip_smoke.GOLDENS_CFG)
ECFG = EngineConfig(prefill_buckets=(64, 128), max_semantic_tokens=16)
REQUESTS = [
    TtsArgs(text="golden fixture text", seed=42, max_tokens=16),
    TtsArgs(text="clone me", seed=5, max_tokens=12,
            ref_global_tokens=list(range(0, 4096, 128))),
    TtsArgs(text="你好世界", seed=7, max_tokens=16, gender="male",
            emotion="HAPPY", speed="fast"),
    TtsArgs(text="short", seed=9, max_tokens=8, age="elderly",
            pitch="low_pitch"),
]


@pytest.fixture(scope="module")
def jax_weights():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import BiCodecConfig as JBConfig
    from rwkv_tts_tpu.config import RwkvConfig as JConfig
    from rwkv_tts_tpu.models import bicodec, rwkv7

    return (rwkv7.init_params(JConfig(**chip_smoke.GOLDENS_CFG),
                              jax.random.PRNGKey(1234)),
            bicodec.init_params(JBConfig.tiny(), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def pipe(jax_weights):
    lm, bc = jax_weights
    return TtsPipeline(bridge.rwkv7_params(lm, "cpu"), LM_CFG,
                       bridge.bicodec_params(bc, "cpu"), BiCodecConfig.tiny(),
                       engine_cfg=ECFG, device="cpu")


def test_synthesize_batch_matches_jax_pipeline(jax_weights, pipe):
    from rwkv_tts_tpu.config import BiCodecConfig as JBConfig
    from rwkv_tts_tpu.config import EngineConfig as JEngineConfig
    from rwkv_tts_tpu.config import RwkvConfig as JConfig
    from rwkv_tts_tpu.config import TtsArgs as JArgs
    from rwkv_tts_tpu.runtime.pipeline import TtsPipeline as JPipeline

    lm, bc = jax_weights
    jpipe = JPipeline(lm, JConfig(**chip_smoke.GOLDENS_CFG), bc,
                      JBConfig.tiny(), voice_store=None,
                      engine_cfg=JEngineConfig(prefill_buckets=(64, 128),
                                               max_semantic_tokens=16),
                      use_pallas=False)
    want = jpipe.synthesize_batch(
        [JArgs(**{f: getattr(r, f) for f in r.__dataclass_fields__})
         for r in REQUESTS])
    got = pipe.synthesize_batch(REQUESTS)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.global_tokens == w.global_tokens
        assert g.semantic_tokens == w.semantic_tokens
        assert g.audio.shape == w.audio.shape
        assert g.audio.shape == (len(g.semantic_tokens) * 320,)
        chain_close(g.audio, w.audio)
    assert set(got[0].timings_ms) == {"generate", "detokenize", "total"}
    assert got[0].rtf > 0


def test_save_audio_writes_the_jax_wav_bytes(tmp_path):
    pytest.importorskip("jax")
    from rwkv_tts_tpu.audio.io import encode_wav_16bit

    from rwkv_tts_tpu_torch.runtime.pipeline import SynthesisResult
    audio = np.sin(np.linspace(0, 300, 4000)).astype(np.float32) * 0.3
    res = SynthesisResult(audio=audio, sample_rate=16000, global_tokens=[],
                          semantic_tokens=[], timings_ms={}, rtf=0.0)
    path = tmp_path / "out.wav"
    TtsPipeline.save_audio(res, str(path))
    assert path.read_bytes() == encode_wav_16bit(audio, 16000)
    # MP3 by the suffix, as the JAX pipeline writes it (where no encoder
    # loads, both raise the same error)
    from rwkv_tts_tpu.audio.io import encode_mp3
    mp3 = tmp_path / "out.mp3"
    try:
        want = encode_mp3(audio, 16000)
    except Exception as e:  # noqa: BLE001: compared below
        with pytest.raises(type(e), match=str(e)):
            TtsPipeline.save_audio(res, str(mp3))
    else:
        TtsPipeline.save_audio(res, str(mp3))
        assert mp3.read_bytes() == want


def test_voice_chain_rungs(pipe, caplog):
    prop = pipe.resolve_voice(TtsArgs(text="x", seed=4, zero_shot=True))
    assert not prop.zero_shot and prop.seed == 4
    direct = pipe.resolve_voice(TtsArgs(text="x", seed=4,
                                        ref_global_tokens=[1] * 32))
    assert direct.zero_shot and direct.seed == 0
    with caplog.at_level("WARNING"):
        assert not pipe.resolve_voice(TtsArgs(voice_id="v1")).zero_shot
    assert "voice_id" in caplog.text
    # no wav2vec2 weights here: a reference file falls down the chain, as in
    # the JAX pipeline (tests/test_torch_cloning.py covers the rung itself)
    with caplog.at_level("WARNING"):
        ref = pipe.resolve_voice(TtsArgs(ref_audio_path="ref.wav", seed=4))
    assert not ref.zero_shot and ref.seed == 4
    assert "ref_audio_path" in caplog.text
    # the last opt-in rung: a cached speaker turns the request zero-shot
    # and keeps its seed (tests/test_torch_cached_speaker.py)
    cached = pipe.resolve_voice(TtsArgs(text="x", seed=4,
                                        cached_speaker=True))
    assert cached.zero_shot and cached.seed == 4
    assert len(cached.ref_global_tokens) == 32


def test_empty_generation_vocodes_one_second_of_silence(pipe):
    from rwkv_tts_tpu_torch.runtime.engine import GenerationResult

    wav = pipe.vocode(GenerationResult([0] * 32, [], 0, 32))
    assert wav.shape == (16000,) and not wav.any()


def test_chip_smoke_main_path_at_tiny_shapes():
    """chip_smoke.py's main path and its checks, on the CPU at the goldens
    LM and the tiny codec (the card run uses full width)."""
    out = chip_smoke.main_path(
        torch, LM_CFG, BiCodecConfig.tiny(), "cpu", max_tokens=6,
        engine_cfg=EngineConfig(prefill_buckets=(32, 64),
                                max_semantic_tokens=8), warmup=False)
    assert len(out["results"]) == len(chip_smoke.TEXTS)
    assert out["counters"]["prefill_chunks"] == 1
    # 32 global steps, TAG_1, and semantic steps until the block check
    # finds every slot done
    assert out["counters"]["decode_steps"] == 32 + 1 + 8


def warm_pipe(jax_weights, **kw):
    lm, bc = jax_weights
    return TtsPipeline(bridge.rwkv7_params(lm, "cpu"), LM_CFG,
                       bridge.bicodec_params(bc, "cpu"), BiCodecConfig.tiny(),
                       engine_cfg=EngineConfig(prefill_buckets=(16, 32),
                                               max_semantic_tokens=8,
                                               batch_size=2),
                       device="cpu", **kw)


def warm_labels(pipe, detok_buckets):
    """The labels of the JAX pipeline's warmup (``_warmup_pipeline``) for
    this pipeline's engine configuration, outside tensor parallelism."""
    from rwkv_tts_tpu_torch.runtime.streaming import StreamingVocoder

    ecfg = pipe.engine.engine_cfg
    assert ecfg.batch_size == 2
    labels = {f"lm_{m}_{T}_b{B}" for B in (1, 2)     # {1} ∪ {batch_size}
              for T in ecfg.prefill_buckets[:2] for m in ("normal", "zs")}
    labels |= {f"prefill_{ecfg.prefill_buckets[-1]}", "global_stage",
               "semantic_normal", "semantic_zs"}
    labels |= {f"detokenize_{S}" for S in detok_buckets}
    for mode in ("exact", "low", "ultra", "flash"):
        sv = StreamingVocoder(pipe.bicodec_params, pipe.bicodec_cfg,
                              [0] * 32, latency_mode=mode)
        labels |= {f"stream_{mode}_{W}"
                   for W in (sv.window_bucket, sv.flush_bucket)}
    if pipe.cached_speaker_default:
        labels.add("speaker_cache")
    return labels


def test_warmup_runs_every_serving_shape(jax_weights):
    """``warmup`` runs the JAX warmup's steps under its labels: the batch
    ladder {1, 2, …} ∪ {batch_size} over the first two prefill buckets in
    both modes, a long prompt's chunked prefill and stages, the speaker
    cache when it is the default, the detokenize buckets and both windows
    of every streaming mode; each step's wall seconds."""
    pipe = warm_pipe(jax_weights, cached_speaker_default=True)
    times = pipe.warmup(detok_buckets=(64,))
    assert set(times) == warm_labels(pipe, (64,))
    assert all(isinstance(v, float) and v >= 0 for v in times.values())
    # the cached-speaker entries for seed 0 and for no seed are in place
    assert len(pipe._speaker_cache) == 2


def test_warmup_budget_skips_and_lists(jax_weights):
    """An exhausted ``budget_s`` skips the remaining steps and lists them
    under "skipped" (the staged chain under one label), never errors; an
    unbounded warmup on the same pipeline skips nothing."""
    pipe = warm_pipe(jax_weights)
    times = pipe.warmup(detok_buckets=(64,), budget_s=0.0)
    skipped = times.pop("skipped")
    assert skipped and not set(skipped) & set(times)
    staged = {"prefill_32", "global_stage", "semantic_normal",
              "semantic_zs"}
    want = warm_labels(pipe, (64,))
    assert set(times) | set(skipped) == \
        (want - staged) | {"staged_long_prompt"}
    assert "skipped" not in pipe.warmup(detok_buckets=(64,), budget_s=1e9)

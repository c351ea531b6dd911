"""The port's streaming vocoder and ``stream_synthesize`` on the CPU
(mirrors ``tests/test_streaming.py`` except its tensor-parallel case):
incremental vocoding equals the full bucketed decode in exact mode, the
short-window modes stay close to it, a stream through the continuous engine
carries the engine's tokens, and the speaker tokens resolve in trust
order. Exact mode is also held against the JAX vocoder's stream."""

import threading
import types

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import (BiCodecConfig, EngineConfig,
                                       RwkvConfig, TtsArgs)
from rwkv_tts_tpu_torch.models import bicodec
from rwkv_tts_tpu_torch.runtime.continuous import (ContinuousEngine,
                                                   RequestCancelled)
from rwkv_tts_tpu_torch.runtime.engine import GenerationResult
from rwkv_tts_tpu_torch.runtime.streaming import (StreamingVocoder,
                                                  _resolve_globals,
                                                  stream_synthesize)
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


BC_KW = dict(feat_dim=64, semantic_codebook=128)
BC_CFG = BiCodecConfig.tiny(**BC_KW)
LM_CFG = RwkvConfig(**chip_smoke.GOLDENS_CFG)


@pytest.fixture(scope="module")
def jax_codec():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import BiCodecConfig as JConfig
    from rwkv_tts_tpu.models import bicodec as J

    jcfg = JConfig.tiny(**BC_KW)
    return J, jcfg, J.init_params(jcfg, jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def bc_params(jax_codec):
    return bridge.bicodec_params(jax_codec[2], device="cpu")


def tokens(seed, n=100):
    rng = np.random.default_rng(seed)
    return ([int(t) for t in rng.integers(0, 4096, 32)],
            [int(t) for t in rng.integers(0, 128, n)])


def stream(sv, sem, first=0, step=10):
    parts = [sv.push(sem[:first])] if first else []
    for i in range(first, len(sem), step):
        parts.append(sv.push(sem[i:i + step]))
    parts.append(sv.push([], flush=True))
    return parts


def test_incremental_matches_full_decode(bc_params):
    """Chunked vocoding with the receptive field as context and lookahead
    equals the full bucketed decode everywhere, the edge-padded tail
    included (5e-4, the JAX test's bound: f32 sums at other offsets)."""
    g, sem = tokens(0)
    full = bicodec.detokenize(bc_params, g, sem, BC_CFG, bucket=4)[0]
    sv = StreamingVocoder(bc_params, BC_CFG, g, chunk_tokens=32)
    with chip_smoke.logged_windows(bicodec) as log:
        streamed = np.concatenate(stream(sv, sem))
    assert streamed.shape == full.shape == (100 * 320,)
    np.testing.assert_allclose(streamed, full, atol=5e-4)
    # two window shapes: interior and flush
    assert {n for _, n, _ in log} == {sv.window_bucket, sv.flush_bucket}
    assert sv.flush_bucket % sv.window_bucket == 0


def test_exact_stream_matches_jax_vocoder(jax_codec, bc_params):
    """The same pushes through the JAX ``StreamingVocoder``: the same chunk
    boundaries, samples within the BiCodec chain bound."""
    from rwkv_tts_tpu.runtime.streaming import StreamingVocoder as JVocoder

    J, jcfg, jp = jax_codec
    g, sem = tokens(4, n=90)
    want = stream(JVocoder(jp, jcfg, g, chunk_tokens=32), sem)
    got = stream(StreamingVocoder(bc_params, BC_CFG, g, chunk_tokens=32), sem)
    assert [len(a) for a in got] == [len(a) for a in want]
    chain_close(np.concatenate(got), np.concatenate(want))


def test_low_latency_mode_close_to_exact(bc_params):
    g, sem = tokens(1)
    full = bicodec.detokenize(bc_params, g, sem, BC_CFG, bucket=4)[0]
    sv = StreamingVocoder(bc_params, BC_CFG, g, chunk_tokens=32,
                          low_latency=True)
    assert sv.lookahead == 16 and sv.context == 32
    streamed = np.concatenate(stream(sv, sem))
    assert streamed.shape == full.shape
    assert float(np.abs(streamed - full).mean()) < 0.05
    assert np.all(np.isfinite(streamed))


def test_ultra_latency_mode(bc_params):
    g, sem = tokens(2)
    full = bicodec.detokenize(bc_params, g, sem, BC_CFG, bucket=4)[0]
    sv = StreamingVocoder(bc_params, BC_CFG, g, latency_mode="ultra")
    assert (sv.chunk, sv.context, sv.lookahead) == (16, 16, 8)
    parts = stream(sv, sem, first=24)
    # the first audio comes once chunk + lookahead = 24 tokens exist
    assert parts[0].shape == (16 * 320,)
    streamed = np.concatenate(parts)
    assert streamed.shape == full.shape
    err = np.abs(streamed - full)
    assert float(err.mean()) < 0.5 * float(np.abs(full).mean() + 1e-9)
    assert np.all(np.isfinite(streamed))
    with pytest.raises(ValueError):
        StreamingVocoder(bc_params, BC_CFG, g, latency_mode="warp")


def test_flash_latency_mode(bc_params):
    g, sem = tokens(3, n=64)
    full = bicodec.detokenize(bc_params, g, sem, BC_CFG, bucket=4)[0]
    sv = StreamingVocoder(bc_params, BC_CFG, g, latency_mode="flash")
    assert (sv.chunk, sv.context, sv.lookahead) == (8, 16, 4)
    parts = stream(sv, sem, first=12, step=7)
    assert parts[0].shape == (8 * 320,)
    streamed = np.concatenate(parts)
    assert streamed.shape == full.shape
    err = np.abs(streamed - full)
    assert float(err.mean()) < 0.6 * float(np.abs(full).mean() + 1e-9)
    assert np.all(np.isfinite(streamed))


# the engine emits semantic ids up to 8191: the end-to-end streams vocode
# through a codec with the full semantic codebook
E2E_CFG = BiCodecConfig.tiny(feat_dim=64)


@pytest.fixture(scope="module")
def e2e_params():
    return bicodec.init_params(E2E_CFG, device="cpu")


@pytest.fixture(scope="module")
def cont():
    params = bridge.rwkv7_params(chip_smoke.goldens_params(LM_CFG, 1234),
                                 "cpu")
    eng = ContinuousEngine(
        params, LM_CFG, EngineConfig(prefill_buckets=(32, 64),
                                     max_semantic_tokens=24, batch_size=2),
        block=8, slots=2, device="cpu")
    yield eng
    eng.stop()


def test_streaming_end_to_end_with_engine(cont, e2e_params):
    """A stream's chunks are the exact-mode vocoding of the tokens the
    engine emits for the request: the right length, a final chunk last,
    and the one-shot detokenize of those tokens within 5e-4."""
    args = TtsArgs(text="stream this text", seed=3, max_tokens=24)
    chunks = list(stream_synthesize(cont, e2e_params, E2E_CFG, args,
                                    chunk_tokens=8, timeout=300.0))
    assert chunks[-1].final and not any(c.final for c in chunks[:-1])
    assert [c.seq for c in chunks] == list(range(len(chunks)))
    audio = np.concatenate([c.audio for c in chunks])
    res = cont.generate(TtsArgs(text="stream this text", seed=3,
                                max_tokens=24), timeout=300.0)
    assert len(res.semantic_tokens) == 24
    assert audio.shape == (24 * 320,) and np.all(np.isfinite(audio))
    full = bicodec.detokenize(e2e_params, res.global_tokens,
                              res.semantic_tokens, E2E_CFG)[0]
    np.testing.assert_allclose(audio, full, atol=5e-4)


def test_stream_of_a_cancelled_request_raises(cont, e2e_params):
    args = TtsArgs(text="cancel this stream", seed=4, max_tokens=24)
    it = stream_synthesize(cont, e2e_params, E2E_CFG, args, chunk_tokens=8,
                           latency_mode="flash", timeout=300.0)
    first = next(it)
    assert not first.final and first.audio.size == 8 * 320
    if cont.cancel(args):
        with pytest.raises(RequestCancelled):
            list(it)


def test_resolve_globals_trust_order():
    eng = types.SimpleNamespace(_lock=threading.Lock(), _live={})
    args = TtsArgs(text="short")
    res = GenerationResult(list(range(32)), [1, 2, 3], 4, 35)
    fired = threading.Event()
    fired.set()

    # retired, result available: the result's speaker tokens
    assert _resolve_globals(eng, args, {"res": res}, fired) == list(range(32))
    # zero-shot fallback: the request carries its own reference tokens
    zs = TtsArgs(text="short", zero_shot=True, ref_global_tokens=[7] * 32)
    assert _resolve_globals(eng, zs, {}, fired) == [7] * 32
    # an engine failure is not a result
    with pytest.raises(RuntimeError, match="speaker tokens"):
        _resolve_globals(eng, args, {"res": ValueError("boom")}, fired)
    # the live slot wins over everything
    eng._live[0] = types.SimpleNamespace(request=args,
                                         global_tokens=[9] * 32)
    assert _resolve_globals(eng, args, {"res": res}, fired) == [9] * 32

    # the retire window: slot already popped, result not yet stored: the
    # resolver waits for the result callback instead of raising
    eng._live.clear()
    box, pending = {}, threading.Event()

    def late_result():
        box["res"] = res
        pending.set()

    t = threading.Timer(0.2, late_result)
    t.start()
    try:
        assert _resolve_globals(eng, args, box, pending) == list(range(32))
    finally:
        t.cancel()


def test_chip_smoke_streaming_phase_at_tiny_shapes():
    """chip_smoke.py's streaming phase and its checks, on the CPU at the
    goldens LM and a small codec whose first two blocks are wide enough for
    ``ops.conv1d`` (the card run uses full width): 8 staggered streams in
    every latency mode, the cancel, the goldens requests through the
    continuous engine, and on the CPU every request emits the static
    engine's tokens."""
    import os

    cfg = BiCodecConfig.tiny(dec_channels=384, conv_impl="mxu_fused")
    out = chip_smoke.streaming(
        torch, LM_CFG, cfg, "cpu",
        engine_cfg=EngineConfig(prefill_buckets=(32, 64),
                                max_semantic_tokens=160),
        block=8, tokens={"exact": 130, "low": 70, "ultra": 40, "flash": 24},
        stagger_s=0.05, exact_tol=1e-3, warmup=False,
        goldens_root=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
        solo_plan=(("cached", "flash"), ("property", "ultra")))
    assert out["same"] == 8 and out["goldens"] == 4
    assert [r["chunks"] for r in out["solo"]] == [3, 3]
    assert len(out["buckets"]) >= 2
    assert len(out["exact"]) == 2
    assert out["conv_per_window"] == 12 and out["windows"] >= 16
    assert out["launches"]["conv1d"] == 0           # the CPU launches none
    assert out["packs"] == {"conv1d": 0}            # packed at load
    assert {r["mode"] for r in out["runs"]} == {"exact", "low", "ultra",
                                                "flash"}
    assert out["hist"]["queue_wait"][0] == 8
    assert out["hist"]["first_emit"][0] == 8

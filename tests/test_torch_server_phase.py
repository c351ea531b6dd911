"""chip_smoke.py's ``server`` phase and its checks, on the CPU at the
goldens LM (2 × 128), wav2vec2 at 4 layers × 64 and a small codec whose
first two blocks are wide enough for ``ops.conv1d`` (the card run uses full
width): the pipeline's warmup, /healthz, four concurrent /api/tts
requests, one request alone twice byte-equal, the flash and exact streams
of the same request with its WAV's samples, a voice's life over
multipart, /metrics, the static engine through the batcher (equal to the
continuous engine's WAV, asserted on the CPU), the MP3 round trip where
the libraries load, and /debug/trace."""

import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import (BiCodecConfig, EngineConfig,
                                       RwkvConfig, Wav2Vec2Config)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test worker: the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_server_phase_at_tiny_shapes():
    out = chip_smoke.server(
        torch, RwkvConfig(**chip_smoke.GOLDENS_CFG),
        BiCodecConfig.tiny(feat_dim=64, dec_channels=384,
                           conv_impl="mxu_fused"),
        Wav2Vec2Config(num_layers=4, hidden_size=64, num_heads=4,
                       ffn_size=128, conv_dims=(32,) * 7), "cpu",
        engine_cfg=EngineConfig(prefill_buckets=(64, 128),
                                max_semantic_tokens=16),
        w2v_layers=(2, 3))
    assert [r["status"] for r in out["requests"]] == [200] * 7
    # the server without --warmup, before the measured one
    assert [r["what"] for r in out["cold"]["requests"]] == \
        [f"cold concurrent {i}" for i in range(4)] + ["cold alone"]
    assert {r["samples"] for r in out["cold"]["requests"]} == {16 * 320}
    assert "continuous" in out["warmup"]
    assert [r["what"] for r in out["requests"]][-1] == "by voice_id"
    assert {r["samples"] for r in out["requests"][:6]} == {16 * 320}
    assert [s["mode"] for s in out["streams"]] == ["flash", "exact"]
    assert all(s["samples"] == 16 * 320 and s["first_chunk_ms"] > 0
               for s in out["streams"])
    assert out["voice"]["delete"] == 200 and \
        out["voice"]["after_delete"] == 404
    assert out["continuous_blocks"] > 0
    assert out["static"]["same_as_continuous"] is True
    assert out["static"]["batcher"]["batched_requests"] == 2
    assert out["mp3"].startswith(("MP3 round trip", "MP3 check not run"))
    assert out["launches"]["conv1d"] == 0          # the CPU launches none
    assert {"lm_normal_64_b1", "lm_zs_64_b1", "prefill_128",
            "detokenize_64"} <= set(out["warmup"])

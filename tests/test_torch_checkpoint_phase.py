"""chip_smoke.py's ``checkpoint`` phase and its host-side writers, on the
CPU: the inverse-mapping writer (``webrwkv_tensors`` + ``write_safetensors``)
round-trips a 2 × 128 LM through the port's ``load_rwkv7`` bit for bit
(bf16 matrices, f32 vectors, the padded vocabulary and layer 0's v-lora
zeroed as a file carries them), and the whole phase runs at tiny shapes: the
model files written, the server started on them with ``--quant-type int8``,
the LM bit checks, the codec cross-validation, the transpiled wav2vec2,
the requests over HTTP and the graph's vocoder window."""

import dataclasses

import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import (BiCodecConfig, RwkvConfig,
                                       Wav2Vec2Config)
from rwkv_tts_tpu_torch.models import codec_loader, convert, rwkv7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test worker: the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_checkpoint_is_a_phase():
    assert chip_smoke.PHASES[-1] == "checkpoint"
    assert chip_smoke.parse_phases(["--phases", "checkpoint,server"]) == \
        ["server", "checkpoint"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_webrwkv_writer_round_trips_through_load_rwkv7(tmp_path, dtype):
    cfg = RwkvConfig(**{**chip_smoke.GOLDENS_CFG, "dtype": dtype,
                        "param_dtype": dtype})
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    params = chip_smoke.canonical_lm(rwkv7.init_params(cfg, gen, "cpu"), cfg)
    # nonzero mix vectors and loras, so a transposed or swapped key shows
    for k, v in params["blocks"].items():
        if k not in ("v0", "v1", "v2"):
            v.add_(torch.randn(v.shape, generator=gen).to(v.dtype) * 0.01)
    path = str(tmp_path / "webrwkv.safetensors")
    names = chip_smoke.webrwkv_tensors(params, cfg)
    assert "blocks.0.att.v1" not in names and "blocks.1.att.v1" in names
    chip_smoke.write_safetensors(torch, path, names)
    loaded, lcfg = convert.load_rwkv7(path, dtype=dtype, device="cpu")
    assert dataclasses.replace(lcfg, padded_vocab_size=0) == \
        dataclasses.replace(cfg, padded_vocab_size=0)
    PV = lcfg.padded_vocab_size
    want = {**params, "emb": params["emb"][:PV],
            "head": params["head"][:, :PV]}
    flat_w = {**{k: v for k, v in want.items() if k != "blocks"},
              **{"blocks." + k: v for k, v in want["blocks"].items()}}
    flat_l = {**{k: v for k, v in loaded.items() if k != "blocks"},
              **{"blocks." + k: v for k, v in loaded["blocks"].items()}}
    assert sorted(flat_l) == sorted(flat_w)
    for k, v in flat_w.items():
        assert flat_l[k].dtype == v.dtype, k
        assert torch.equal(flat_l[k], v), k


def test_chip_smoke_checkpoint_phase_at_tiny_shapes(monkeypatch):
    # the server's startup path picks its device from the environment, and
    # the codec loader reads the published BiCodec's shapes: here, the
    # tiny codec's
    monkeypatch.setenv("RWKV_TTS_PLATFORM", "cpu")
    bc_cfg = BiCodecConfig.tiny(feat_dim=64)
    monkeypatch.setattr(codec_loader, "BiCodecConfig", lambda: bc_cfg)
    # the goldens LM in the server's load dtype, bf16 (the main path's)
    lm_cfg = RwkvConfig(**{**chip_smoke.GOLDENS_CFG, "dtype": "bfloat16",
                           "param_dtype": "bfloat16"})
    out = chip_smoke.checkpoint(
        torch, lm_cfg, bc_cfg,
        Wav2Vec2Config(num_layers=4, hidden_size=64, num_heads=4,
                       ffn_size=128, conv_dims=(32,) * 7), "cpu",
        max_tokens=16, w2v_layers=(1, 2))      # layers 3, 4 left out
    assert out["lm_equal"] and out["lm_int8_equal"]
    p = out["parity"]
    assert p["decode_max_abs"] < 5e-3
    assert p["semantic_match"] >= 0.9 and p["global_match"] >= 0.9
    assert out["w2v_rel_err"] < 1e-4
    assert [r["what"] for r in out["requests"]] == \
        ["property 0", "property 1", "by voice_id"]
    assert all(r["samples"] == 16 * 320 for r in out["requests"])
    assert out["stream"]["samples"] == 16 * 320
    assert out["window"]["max_abs"] < 5e-3
    assert out["launches"]["wkv7_decode"] == 0     # the CPU launches none
    assert out["healthz"]["n_layer"] == 2
    assert {"write LM", "LM read, map, to device", "quantize int8",
            "codec resolve in all"} <= set(out["times_s"])
    # the published layout: fetched from the mirror, every stage passed
    pub = out["published"]
    assert all(v["ok"] for v in pub["report"].values()), pub["report"]
    assert list(pub["seconds"]) == list(pub["report"])
    assert pub["served"] == {"bicodec_onnx": True, "wav2vec2_onnx": True}
    assert pub["report"]["continuous_replay"]["mismatched_seeds"] == []
    assert "published layout, fetched and validated" in out["times_s"]
    lines = chip_smoke.checkpoint_lines(out, lm_cfg, "a card, 700 W")
    assert len(lines) == 6 and all(ln.startswith("checkpoint: ")
                                   for ln in lines)
    print("\n".join(lines))

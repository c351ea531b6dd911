"""The slice as a whole on the CPU: ``TtsPipeline.from_checkpoints`` of the
port and of the JAX package on one synthetic model directory (a 2 × 128
RWKV-7 checkpoint in BlinkDL's names, V = 77923; a tiny BiCodec as a state
dict plus its two exports; a wav2vec2 export), the server's and the CLI's
``--model-path``:

  * both packages load the same LM tree and serve the codecs the same way
    (the published BiCodec shapes do not fit the tiny state dict, so both
    serve the exported graphs), and emit the same tokens for the goldens
    requests, with waveforms within the graph tests' bound (rtol 1e-3,
    atol 1e-4);
  * every ``--quant-type`` (``sf4`` as ``nf4``) with ``--quant-layers``,
    and ``fuse``, give the JAX tree bit for bit through the server's own
    startup path;
  * enrollment through the exported codecs gives the torch chain's tokens
    (an HF wav2vec2 export, the contract of tests/test_e2e_onnx_codecs.py;
    needs ``transformers``);
  * a stream through the exported BiCodec equals ``detokenize`` of its
    tokens; the directory rule prefers rwkvtts-Int8_22.safetensors; a
    missing codec raises unless random codecs are allowed; the CLI
    synthesizes from ``--model-path``."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu.config import EngineConfig as JEngineConfig
from rwkv_tts_tpu.config import TtsArgs as JArgs
from rwkv_tts_tpu.models import bicodec as JB
from rwkv_tts_tpu.models import convert as JC
from rwkv_tts_tpu.ops import quant as JQ
from rwkv_tts_tpu.runtime.pipeline import TtsPipeline as JPipeline
from rwkv_tts_tpu_torch.audio.io import encode_wav_16bit, read_wav
from rwkv_tts_tpu_torch.cli import main as cli_main
from rwkv_tts_tpu_torch.config import (BiCodecConfig, EngineConfig, TtsArgs,
                                       Wav2Vec2Config)
from rwkv_tts_tpu_torch.models import bicodec, wav2vec2
from rwkv_tts_tpu_torch.runtime.continuous import ContinuousEngine
from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline
from rwkv_tts_tpu_torch.runtime.streaming import stream_synthesize
from rwkv_tts_tpu_torch.server import app as A
from rwkv_tts_tpu_torch.tokenizer import load_tokenizer

from test_convert import make_rwkv7_checkpoint, write_safetensors
from test_torch_convert import assert_same_tree

# the tiny codec keeps the real token spaces (semantic 8192, global 4096),
# so the LM's tokens are in range
BC_CFG = BiCodecConfig.tiny(feat_dim=24)
W2V_CFG = Wav2Vec2Config(num_layers=2, hidden_size=24, num_heads=2,
                         ffn_size=48, conv_dims=(16,) * 7)
ECFG = dict(prefill_buckets=(64, 128), max_semantic_tokens=16)
VOCAB = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "model", "vocab_canonical.txt")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("model")
    write_safetensors(str(d / "webrwkv.safetensors"),
                      make_rwkv7_checkpoint(V=77923))
    chip_smoke.bicodec_files(torch, str(d), BC_CFG, seed=0)
    w2v = wav2vec2.init_params(W2V_CFG, torch.Generator().manual_seed(1),
                               "cpu")
    chip_smoke.wav2vec2_file(torch, str(d / "wav2vec2-large-xlsr-53.onnx"),
                             w2v, W2V_CFG, (1, 2))
    return d


@pytest.fixture(scope="module")
def pipes(model_dir, tmp_path_factory):
    raf = tmp_path_factory.mktemp("raf")
    mine = TtsPipeline.from_checkpoints(
        str(model_dir), raf_dir=str(raf), dtype="float32",
        engine_cfg=EngineConfig(**ECFG), device="cpu")
    theirs = JPipeline.from_checkpoints(
        str(model_dir), raf_dir=str(raf), dtype="float32",
        engine_cfg=JEngineConfig(**ECFG), use_pallas=False)
    return mine, theirs


def test_from_checkpoints_goldens_match_jax(pipes):
    mine, theirs = pipes
    assert isinstance(mine.bicodec_params, bicodec.OnnxBiCodec)
    assert isinstance(theirs.bicodec_params, JB.OnnxBiCodec)
    assert isinstance(mine.w2v_params, wav2vec2.OnnxWav2Vec2)
    assert mine.engine.cfg.__dict__ == theirs.engine.cfg.__dict__
    assert_same_tree(mine.engine.params, theirs.engine.params)
    reqs = list(chip_smoke.goldens_requests(TtsArgs).values())
    got = mine.synthesize_batch(reqs)
    want = theirs.synthesize_batch([JArgs(**dataclasses.asdict(r))
                                    for r in reqs])
    for g, w in zip(got, want):
        assert g.global_tokens == w.global_tokens
        assert g.semantic_tokens == w.semantic_tokens
        assert g.audio.shape == (320 * len(g.semantic_tokens),)
        np.testing.assert_allclose(g.audio, w.audio, rtol=1e-3, atol=1e-4)


def test_warmup_runs_through_the_graphs(pipes):
    """``warmup`` decodes the streaming windows through the exported
    BiCodec when that is what the pipeline serves."""
    out = pipes[0].warmup(prefill_buckets=(64,), detok_buckets=(64,),
                          zero_shot_too=False, batch_ladder=(1,))
    assert {"detokenize_64", "stream_flash_28"} <= set(out)
    assert "skipped" not in out


def test_stream_through_the_graphs_equals_detokenize(pipes):
    """``stream_synthesize`` over the loaded pipeline's continuous engine
    with the exported BiCodec as its vocoder: exact mode gives the samples
    of ``detokenize`` of the same tokens (5e-4, the streaming tests'
    bound)."""
    pipe = pipes[0]
    eng = pipe.engine
    cont = ContinuousEngine(eng.params, eng.cfg, eng.engine_cfg, slots=2,
                            buckets=(), device="cpu")
    try:
        args = pipe.resolve_voice(TtsArgs(text="golden fixture text",
                                          seed=42, max_tokens=16))
        chunks = list(stream_synthesize(cont, pipe.bicodec_params,
                                        pipe.bicodec_cfg, args,
                                        latency_mode="exact"))
    finally:
        cont.stop()
    assert chunks[-1].final
    audio = np.concatenate([c.audio for c in chunks])
    n = len(audio) // 320
    assert n > 0
    # the stream's tokens are the engine's; vocode them whole
    res = eng.generate_batch([args])[0]
    assert len(res.semantic_tokens) == n
    full = bicodec.detokenize(pipe.bicodec_params, res.global_tokens,
                              res.semantic_tokens, pipe.bicodec_cfg)[0]
    np.testing.assert_allclose(audio, full, atol=5e-4)


@pytest.fixture(scope="module")
def small_dir(model_dir, tmp_path_factory):
    """The codecs of ``model_dir`` beside a 2 × 128 LM of V = 1000, and the
    JAX loader's bf16 tree of it (the server's load dtype)."""
    d = tmp_path_factory.mktemp("small")
    for f in model_dir.iterdir():
        if f.suffix == ".onnx" or f.name == "BiCodec.safetensors":
            shutil.copy(f, d / f.name)
    write_safetensors(str(d / "webrwkv.safetensors"), make_rwkv7_checkpoint())
    return d, JC.load_rwkv7(str(d / "webrwkv.safetensors"))


@pytest.mark.parametrize("quant,layers", [
    ("int8", -1), ("int8", 1), ("int4", 1), ("nf4", -1), ("sf4", 1),
    ("none", -1), ("fuse", -1)])
def test_server_startup_trees_equal_jax(small_dir, tmp_path, monkeypatch,
                                        quant, layers):
    """``build_pipeline_from_args`` (``--quant-type``, ``--quant-layers``)
    and ``from_checkpoints(fuse=True)`` give the JAX package's tree bit for
    bit (bf16 load, as the server loads)."""
    from rwkv_tts_tpu.models import rwkv7 as JR

    monkeypatch.setenv("RWKV_TTS_PLATFORM", "cpu")
    d, (jp, jcfg) = small_dir
    if quant == "fuse":
        pipe = TtsPipeline.from_checkpoints(
            str(d), raf_dir=str(tmp_path), fuse=True, device="cpu")
        want = JR.fuse_params(jp, jcfg)
    else:
        pipe = A.build_pipeline_from_args(A.parse_args([
            "--model-path", str(d), "--raf-dir", str(tmp_path),
            "--quant-type", quant, "--quant-layers", str(layers),
            "--vocab-path", VOCAB, "--no-download"]))
        assert pipe.engine.tokenizer.encode("vocab") == \
            load_tokenizer(VOCAB).encode("vocab")
        want = jp if quant == "none" else JQ.quantize_rwkv_params(
            jp, quant_layers=layers,
            kind="nf4" if quant == "sf4" else quant)
    assert_same_tree(pipe.engine.params, want)
    assert isinstance(pipe.engine.params["blocks"], tuple) == (
        quant not in ("none", "fuse") and layers == 1)


def test_enrollment_through_exported_codecs_matches_jax(model_dir,
                                                        tmp_path):
    """An HF wav2vec2 export with the layer mix baked in (the reference's
    form) beside the BiCodec exports, built as tests/test_e2e_onnx_codecs.py
    builds them: the port's enrollment tokens equal the torch chain's
    exactly, the contract that file holds the JAX pipeline to. (Running
    the JAX pipeline here too would cost ~17 s of eager op-by-op
    compilation for the same comparison.)"""
    transformers = pytest.importorskip("transformers")
    from rwkv_tts_tpu_torch.audio.frontend import (load_and_process,
                                                   zero_mean_unit_variance)

    torch.manual_seed(0)
    hf = transformers.Wav2Vec2Model(transformers.Wav2Vec2Config(
        vocab_size=32, hidden_size=24, num_hidden_layers=4,
        num_attention_heads=2, intermediate_size=48, conv_dim=(16,) * 7,
        conv_stride=(5, 2, 2, 2, 2, 2, 2),
        conv_kernel=(10, 3, 3, 3, 3, 2, 2), do_stable_layer_norm=True,
        feat_extract_norm="layer", num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, hidden_dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0)).eval()

    class Export(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.hf = hf

        def forward(self, input):
            hs = self.hf(input, output_hidden_states=True).hidden_states
            return (hs[1] + hs[2] + hs[3]) / 3

    codec = tmp_path / "codec"
    codec.mkdir()
    for f in ("BiCodecTokenize.onnx", "BiCodecDetokenize.onnx"):
        shutil.copy(model_dir / f, codec / f)
    chip_smoke.onnx_export(torch, Export(), (torch.randn(1, 8000),),
                           str(codec / "wav2vec2-large-xlsr-53.onnx"),
                           input_names=["input"], output_names=["output"],
                           dynamic_axes={"input": {1: "N"},
                                         "output": {1: "T"}})
    rng = np.random.default_rng(0)
    wav = (np.sin(np.linspace(0, 700, 24000)) * 0.4
           + rng.normal(0, 0.05, 24000)).astype(np.float32)
    clip = tmp_path / "ref.wav"
    clip.write_bytes(encode_wav_16bit(wav, 16000))
    mine = TtsPipeline.from_checkpoints(
        str(model_dir), raf_dir=str(tmp_path), codec_dir=str(codec),
        dtype="float32", device="cpu")
    assert isinstance(mine.w2v_params, wav2vec2.OnnxWav2Vec2)
    assert isinstance(mine.bicodec_params, bicodec.OnnxBiCodec)
    glob, sem, dur = mine.extract_voice_tokens(str(clip))
    pa = load_and_process(str(clip))
    z = zero_mean_unit_variance(pa.wav)
    bc = chip_smoke.bicodec_files(torch, str(tmp_path), BC_CFG, seed=0)
    with torch.no_grad():
        feats = Export()(torch.from_numpy(np.asarray(z, np.float32))[None])
        want_sem, want_glob = bc.tokenize(
            feats, torch.from_numpy(np.asarray(pa.ref_mel[None],
                                               np.float32)))
    assert sem == [int(t) for t in want_sem[0]]
    assert glob == [int(t) for t in want_glob[0]]


def test_directory_rule_and_missing_codecs(model_dir, tmp_path, monkeypatch):
    """rwkvtts-Int8_22.safetensors wins over webrwkv.safetensors; a
    directory with neither raises; a directory without codecs raises
    unless random codecs are allowed (and then logs it), through the
    server's flags."""
    monkeypatch.setenv("RWKV_TTS_PLATFORM", "cpu")
    d = tmp_path / "lm_only"
    d.mkdir()
    shutil.copy(model_dir / "webrwkv.safetensors", d / "webrwkv.safetensors")
    write_safetensors(str(d / "rwkvtts-Int8_22.safetensors"),
                      make_rwkv7_checkpoint(L=1, V=77923))
    argv = ["--model-path", str(d), "--raf-dir", str(tmp_path / "raf"),
            "--no-download"]
    with pytest.raises(FileNotFoundError, match="noise, not speech"):
        A.build_pipeline_from_args(A.parse_args(argv))
    small = {"BiCodecConfig": lambda: BC_CFG,
             "Wav2Vec2Config": lambda: W2V_CFG}
    from rwkv_tts_tpu_torch.models import codec_loader
    for name, fn in small.items():
        monkeypatch.setattr(codec_loader, name, fn)
    pipe = A.build_pipeline_from_args(A.parse_args(
        argv + ["--allow-random-codec"]))
    assert pipe.engine.cfg.n_layer == 1
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="No supported model file"):
        TtsPipeline.from_checkpoints(str(empty), device="cpu")


def test_cli_synth_from_model_path(model_dir, tmp_path, monkeypatch,
                                   capsys):
    monkeypatch.setenv("RWKV_TTS_PLATFORM", "cpu")
    out = tmp_path / "out.wav"
    assert cli_main(["--model-path", str(model_dir), "--raf-dir",
                     str(tmp_path / "raf"), "synth", "hello there", "-o",
                     str(out), "--seed", "4", "--max-tokens", "8"]) == 0
    rep = json.loads(capsys.readouterr().out)
    wav, sr, ch = read_wav(out.read_bytes())
    assert (sr, ch) == (16000, 1)
    assert len(wav) == 320 * rep["semantic_tokens"] > 0
    assert np.all(np.isfinite(wav))


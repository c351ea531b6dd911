"""The port's codec resolution (``rwkv_tts_tpu_torch/models/codec_loader``)
and its ONNX codecs (``bicodec.OnnxBiCodec``, ``wav2vec2.OnnxWav2Vec2``)
against the JAX package's on the CPU, on the exports of
tests/test_codec_loader.py (a torch reference BiCodec with the reference
graphs' I/O names, and its state dict):

  * the port's ``OnnxBiCodec`` decodes as torch and as the JAX one
    (rtol 1e-3, atol 1e-4) and encodes the same tokens exactly;
  * ``load_bicodec`` and ``load_codecs`` make the JAX choice in every case
    (validated native import, ONNX only, a corrupt state dict, a native
    import that diverges, nothing at all: raise or random; each run through
    both packages but the two gated ones, which tests/test_codec_loader.py
    and the JAX loader's code settle), and the native tree is the JAX
    loader's bit for bit;
  * ``load_w2v`` takes a state dict, HF-named ONNX initializers, then the
    graph, as JAX does;
  * ``ecapa_embedding`` on the loaded tree matches JAX; a 3-D ``wav_rec``
    comes back [B, W]; ``detokenize`` through the graphs matches JAX's; a
    stream through the graphs equals their ``detokenize``."""

import logging
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu.config import BiCodecConfig as JBiCodecConfig
from rwkv_tts_tpu.models import bicodec as JB
from rwkv_tts_tpu.models import codec_loader as JL
from rwkv_tts_tpu_torch.config import BiCodecConfig, Wav2Vec2Config
from rwkv_tts_tpu_torch.models import bicodec as PB
from rwkv_tts_tpu_torch.models import codec_loader as PL
from rwkv_tts_tpu_torch.models import convert, wav2vec2
from rwkv_tts_tpu_torch.runtime.streaming import StreamingVocoder

from test_codec_loader import model_dir, torch_model  # noqa: F401
from test_convert import write_safetensors
from test_torch_convert import W2V, assert_same_tree, w2v_state_dict

KW = dict(feat_dim=24, semantic_codebook=64, mel_bins=16)
CFG, JCFG = BiCodecConfig.tiny(**KW), JBiCodecConfig.tiny(**KW)
ONNX = ("BiCodecTokenize.onnx", "BiCodecDetokenize.onnx")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codecs(model_dir):  # noqa: F811
    paths = [str(model_dir / f) for f in ONNX]
    return PB.OnnxBiCodec(*paths, device="cpu"), JB.OnnxBiCodec(*paths)


def copy_onnx(src, dst):
    dst.mkdir()
    for f in ONNX:
        shutil.copy(src / f, dst / f)
    return dst


def test_onnx_codec_matches_torch_and_jax(torch_model, codecs):  # noqa: F811
    torch_model.eval()
    mine, theirs = codecs
    g = np.random.default_rng(0).integers(0, CFG.global_codebook, (1, 32))
    s = np.random.default_rng(1).integers(0, CFG.semantic_codebook, (1, 40))
    with torch.no_grad():
        want = torch_model.detokenize(torch.tensor(s), torch.tensor(g))
    got = mine.decode(g, s)
    assert got.shape == (1, 40 * 320)
    np.testing.assert_allclose(got.numpy(), want.numpy().reshape(1, -1),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs.decode(g, s)),
                               rtol=1e-3, atol=1e-4)
    mel = np.random.default_rng(2).normal(
        size=(1, CFG.mel_bins, 61)).astype(np.float32)
    feat = np.random.default_rng(3).normal(
        size=(1, 30, CFG.feat_dim)).astype(np.float32)
    with torch.no_grad():
        want_sem, want_glob = torch_model.tokenize(torch.tensor(feat),
                                                   torch.tensor(mel))
    sem, glob = mine.encode(feat, mel)
    jsem, jglob = theirs.encode(feat, mel)
    np.testing.assert_array_equal(sem.numpy(), want_sem.numpy())
    np.testing.assert_array_equal(glob.numpy(), want_glob.numpy())
    np.testing.assert_array_equal(sem.numpy(), np.asarray(jsem))
    np.testing.assert_array_equal(glob.numpy(), np.asarray(jglob))


def test_load_bicodec_prefers_validated_native(
        model_dir, caplog):  # noqa: F811
    """Both files, parity holding: the native import is served (the JAX
    loader's choice, tests/test_codec_loader.py), and it is the JAX
    loader's tree."""
    with caplog.at_level(logging.INFO, "rwkv_tts_tpu_torch"):
        params, cfg = PL.load_bicodec(str(model_dir), CFG, device="cpu")
    jparams, _ = JL.load_bicodec(str(model_dir), JCFG, cross_validate=False)
    assert isinstance(params, dict) and isinstance(jparams, dict)
    assert any("matches the ONNX graphs" in r.getMessage()
               for r in caplog.records)
    assert_same_tree(params, jparams)
    report = PL.bicodec_parity(params, PB.OnnxBiCodec(
        *[str(model_dir / f) for f in ONNX], device="cpu"), CFG)
    assert report["decode_max_abs"] < 5e-3
    assert report["semantic_match"] >= 0.9 and report["global_match"] >= 0.9


def test_onnx_only_and_corrupt_state_dict(
        model_dir, tmp_path, caplog):  # noqa: F811
    """Exports alone serve the graphs; a corrupt optional state dict beside
    them is logged and the graphs served, in both packages."""
    only = copy_onnx(model_dir, tmp_path / "onnx_only")
    assert isinstance(PL.load_bicodec(str(only), CFG, device="cpu")[0],
                      PB.OnnxBiCodec)
    assert isinstance(JL.load_bicodec(str(only), JCFG)[0], JB.OnnxBiCodec)
    bad = copy_onnx(model_dir, tmp_path / "corrupt")
    (bad / "BiCodec.safetensors").write_bytes(b"\x00garbage")
    with caplog.at_level(logging.WARNING, "rwkv_tts_tpu_torch"):
        got = PL.load_bicodec(str(bad), CFG, device="cpu")[0]
    assert isinstance(got, PB.OnnxBiCodec)
    assert isinstance(JL.load_bicodec(str(bad), JCFG)[0], JB.OnnxBiCodec)
    assert any("failed to import" in r.getMessage() for r in caplog.records)


def test_diverging_native_import_serves_the_graphs(
        model_dir, tmp_path, caplog):  # noqa: F811
    """A state dict whose decoder drifted from the exports fails the
    cross-validation: the graphs are served and the divergence logged
    (``codec_loader.py:90-97`` of the JAX package)."""
    d = copy_onnx(model_dir, tmp_path / "drift")
    sd = convert.load_state_dict_file(str(model_dir / "bicodec.pt"))
    key = "decoder.model.0.weight_v"
    sd[key] = sd[key] * 1.5 + 0.1
    write_safetensors(str(d / "BiCodec.safetensors"), sd)
    with caplog.at_level(logging.INFO, "rwkv_tts_tpu_torch"):
        got = PL.load_bicodec(str(d), CFG, device="cpu")[0]
    assert isinstance(got, PB.OnnxBiCodec)
    assert any("DIVERGES" in r.getMessage() for r in caplog.records)


def test_missing_codecs_raise_or_go_random(tmp_path, caplog, monkeypatch):
    """Nothing in the directory: both packages raise; with ``allow_random``
    the port logs an ERROR and serves seeded random codecs (the default
    configurations swapped for small ones here)."""
    for load in (JL.load_codecs,
                 lambda d: PL.load_codecs(d, device="cpu")):
        with pytest.raises(FileNotFoundError, match="noise, not speech"):
            load(str(tmp_path))
    monkeypatch.setattr(PL, "BiCodecConfig", lambda: CFG)
    monkeypatch.setattr(PL, "Wav2Vec2Config", lambda: Wav2Vec2Config(**W2V))
    with caplog.at_level(logging.ERROR, "rwkv_tts_tpu_torch"):
        bc, bc_cfg, w2v, w2v_cfg, layers = PL.load_codecs(
            str(tmp_path), allow_random=True, device="cpu")
    assert isinstance(bc, dict) and isinstance(w2v, dict)
    assert bc["quantizer"]["codebook"].shape == (bc_cfg.semantic_codebook,
                                                 bc_cfg.codebook_dim)
    assert layers == wav2vec2.OUTPUT_LAYERS
    assert any("RANDOM codec weights" in r.getMessage()
               for r in caplog.records)


def test_load_w2v_order_matches_jax(tmp_path):
    """A state dict first; then an ONNX file whose initializers keep the HF
    names (loaded natively); then a graph (served as ``OnnxWav2Vec2``)."""
    from rwkv_tts_tpu.config import Wav2Vec2Config as JW
    from rwkv_tts_tpu.models import wav2vec2 as JW2

    cfg, jcfg = Wav2Vec2Config(**W2V), JW(**W2V)
    sd = w2v_state_dict(cfg, np.random.default_rng(0))
    d1 = tmp_path / "sd"
    d1.mkdir()
    write_safetensors(str(d1 / "wav2vec2.safetensors"), sd)
    mine, _, layers = PL.load_w2v(str(d1), cfg, device="cpu")
    theirs, _, jlayers = JL.load_w2v(str(d1), jcfg)
    assert layers == jlayers
    assert_same_tree(mine, theirs)

    # initializers only, HF-named (an ONNX file the reader understands)
    from test_convert import _field, _varint

    def tensor(name, arr):
        dims = b"".join(_field(1, 0, _varint(d)) for d in arr.shape)
        return _field(5, 2, dims + _field(2, 0, _varint(1))
                      + _field(8, 2, name.encode())
                      + _field(9, 2, arr.astype("<f4").tobytes()))

    d2 = tmp_path / "inits"
    d2.mkdir()
    (d2 / "wav2vec2-large-xlsr-53.onnx").write_bytes(_field(7, 2, b"".join(
        tensor(k, v) for k, v in sd.items())))
    mine, _, _ = PL.load_w2v(str(d2), cfg, device="cpu")
    theirs, _, _ = JL.load_w2v(str(d2), jcfg)
    assert isinstance(mine, dict) and isinstance(theirs, dict)
    assert_same_tree(mine, theirs)

    # a graph: the port's extractor exported with its layer mix baked in
    d3 = tmp_path / "graph"
    d3.mkdir()
    params = wav2vec2.init_params(cfg, torch.Generator().manual_seed(1),
                                  "cpu")
    chip_smoke.wav2vec2_file(torch, str(d3 / "wav2vec2-large-xlsr-53.onnx"),
                             params, cfg, (1, 2))
    mine, _, _ = PL.load_w2v(str(d3), cfg, device="cpu")
    theirs, _, _ = JL.load_w2v(str(d3), jcfg)
    assert isinstance(mine, wav2vec2.OnnxWav2Vec2)
    assert isinstance(theirs, JW2.OnnxWav2Vec2)
    z = np.random.default_rng(2).standard_normal((1, 8000)).astype(
        np.float32)
    got = mine.extract(z)
    want = wav2vec2.extract_features(params, z, cfg, output_layers=(1, 2),
                                     device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_ecapa_embedding_matches_jax(model_dir):  # noqa: F811
    mine, _ = PL.load_bicodec(str(model_dir), CFG, cross_validate=False,
                              device="cpu")
    theirs, _ = JL.load_bicodec(str(model_dir), JCFG, cross_validate=False)
    latent = np.random.default_rng(5).normal(
        size=(2, 3 * CFG.spk_channels, 37)).astype(np.float32)
    got = PB.ecapa_embedding(mine["speaker"]["ecapa"],
                             torch.from_numpy(latent))
    want = np.asarray(JB.ecapa_embedding(theirs["speaker"]["ecapa"], latent))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_onnx_decode_normalizes_3d_wav_rec(
        torch_model, tmp_path):  # noqa: F811
    """An export that keeps a size-1 channel axis still decodes to
    [B, W], so detokenize's and the streaming windows' [:, :S·hop] slices
    see samples, not the channel axis."""

    class Detok3D(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = torch_model

        def forward(self, global_tokens, semantic_tokens):
            return self.m.detokenize(
                semantic_tokens, global_tokens.squeeze(1)).unsqueeze(1)

    g = torch.randint(0, CFG.global_codebook, (1, 1, 32))
    s = torch.randint(0, CFG.semantic_codebook, (1, 24))
    path = str(tmp_path / "BiCodecDetokenize.onnx")
    chip_smoke.onnx_export(torch, Detok3D(), (g, s), path,
                           input_names=["global_tokens", "semantic_tokens"],
                           output_names=["wav_rec"],
                           dynamic_axes={"semantic_tokens": {1: "S"},
                                         "wav_rec": {2: "N"}})
    torch_model.eval()
    codec = PB.OnnxBiCodec(None, path, device="cpu")
    assert codec.decode(g.squeeze(1), s).shape == (1, 24 * 320)
    full = PB.detokenize(codec, list(g[0, 0].numpy()), list(s[0].numpy()),
                         None, bucket=16)
    assert full.shape == (1, 24 * 320) and np.all(np.isfinite(full))


def test_detokenize_and_stream_through_the_graphs(
        model_dir, codecs):  # noqa: F811
    """``detokenize`` of the graphs matches that of the native import of
    the same weights (the graph's decode is held against JAX above); with
    cfg None it pads by the published dimensions (``BiCodecConfig()``); an
    exact-mode stream through the graphs equals their ``detokenize``
    (5e-4, the streaming tests' bound)."""
    mine, _ = codecs
    native, _ = PL.load_bicodec(str(model_dir), CFG, cross_validate=False,
                                device="cpu")
    g = list(range(32))
    s = [int(x) for x in np.random.default_rng(4).integers(
        0, CFG.semantic_codebook, 37)]
    got = PB.detokenize(mine, g, s, CFG, bucket=16)
    want = PB.detokenize(native, g, s, CFG, bucket=16)
    assert got.shape == (1, 37 * 320)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    published = PB.detokenize(mine, g, s, BiCodecConfig(), bucket=16)
    np.testing.assert_array_equal(PB.detokenize(mine, g, s, None, bucket=16),
                                  published)
    full = PB.detokenize(mine, g, s, CFG, bucket=4)[0]
    sv = StreamingVocoder(mine, CFG, g, chunk_tokens=16)
    parts = [sv.push(s[i:i + 7]) for i in range(0, len(s), 7)]
    streamed = np.concatenate(parts + [sv.push([], flush=True)])
    np.testing.assert_allclose(streamed, full, atol=5e-4)
    with pytest.raises(ValueError, match="outside the codebook"):
        PB.detokenize(mine, g, [CFG.semantic_codebook], CFG)

"""The port's first-contact validator
(``rwkv_tts_tpu_torch/tools/validate_real_assets.py``) on the published
file layout, on the CPU, held against the JAX tool
(``tools/validate_real_assets.py``).

The asset directory holds exactly the five published files: a real-layout
``webrwkv.safetensors`` (2 × 128, the full 77,923-token vocabulary),
the repo's ``tokenizer.json``, and the codecs as exports only (a tiny
BiCodec's two graphs and a wav2vec2 graph, written by ``chip_smoke``'s
``bicodec_files`` / ``wav2vec2_file``; no BiCodec state dict), so the
codecs are served by ``OnnxBiCodec`` / ``OnnxWav2Vec2`` as a deployment of
the published files serves them. The full run fetches them first through
the port's downloader from a ``file://`` mirror, the public mirrors
patched out.
"""

import ast
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.audio.io import read_wav
from rwkv_tts_tpu_torch.config import BiCodecConfig, Wav2Vec2Config
from rwkv_tts_tpu_torch.models import bicodec, codec_loader, wav2vec2
from rwkv_tts_tpu_torch.tools import validate_real_assets as V
from rwkv_tts_tpu_torch.utils import download

from test_convert import make_rwkv7_checkpoint, write_safetensors

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(ROOT, "tools", "validate_real_assets.py")
# the tiny codec keeps the real token spaces (semantic 8192, global 4096)
BC_CFG = BiCodecConfig.tiny(feat_dim=24)
W2V_CFG = Wav2Vec2Config(num_layers=2, hidden_size=24, num_heads=2,
                         ffn_size=48, conv_dims=(16,) * 7)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_public_mirrors(monkeypatch):
    monkeypatch.setattr(download, "MIRRORS", ())
    monkeypatch.delenv("HF_ENDPOINT", raising=False)


@pytest.fixture(scope="module")
def asset_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("published")
    write_safetensors(str(d / "webrwkv.safetensors"),
                      make_rwkv7_checkpoint(L=2, C=128, H=2, N=64, V=77923))
    shutil.copy(os.path.join(ROOT, "assets", "model", "tokenizer.json"),
                d / "tokenizer.json")
    chip_smoke.bicodec_files(torch, str(d), BC_CFG, seed=0)
    os.remove(d / "BiCodec.safetensors")        # the exports only
    w2v = wav2vec2.init_params(W2V_CFG, torch.Generator().manual_seed(1),
                               "cpu")
    chip_smoke.wav2vec2_file(torch, str(d / "wav2vec2-large-xlsr-53.onnx"),
                             w2v, W2V_CFG, (1, 2))
    assert sorted(os.listdir(d)) == sorted(download.MODEL_FILES)
    return d


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX tool as a module (its helpers; ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location("jax_validate", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_stage_fields():
    """The JAX tool's ``stage(name, ok, **fields)`` calls: the field names
    each stage's report may carry, by name, and the names in source
    order."""
    tree = ast.parse(open(JAX_TOOL).read())
    calls = sorted((n for n in ast.walk(tree)
                    if isinstance(n, ast.Call)
                    and getattr(n.func, "id", "") == "stage"),
                   key=lambda n: (n.lineno, n.col_offset))
    fields = {}
    for c in calls:
        fields.setdefault(c.args[0].value, set()).update(
            k.arg for k in c.keywords)
    return fields, list(fields)


def run(tmp_path, asset_dir, *argv, download_from=None, monkeypatch=None):
    """The validator in-process on a copy of the shipped voices; returns
    (exit code, report, out dir). ``download_from``: an empty model
    directory is filled from a ``file://`` mirror of ``asset_dir``."""
    raf = tmp_path / "raf"
    shutil.copytree(os.path.join(ROOT, "assets", "raf"), raf)
    out = tmp_path / "out"
    model = asset_dir
    if download_from is not None:
        hub = tmp_path / "hub" / "cgisky" / "rwkv-tts" / "resolve" / "main"
        hub.mkdir(parents=True)
        for f in download.MODEL_FILES:
            os.symlink(asset_dir / f, hub / f)
        monkeypatch.setenv("HF_ENDPOINT", f"file://{tmp_path}/hub")
        model = tmp_path / "model"
        argv = [a for a in argv if a != "--no-download"]
    rc = V.main(["--model-dir", str(model), "--raf-dir", str(raf),
                 "--out", str(out), *argv], device="cpu")
    return rc, json.loads((out / "report.json").read_text()), out


def test_all_stages_pass_from_a_mirror(asset_dir, tmp_path, monkeypatch,
                                       capsys):
    rc, report, out = run(tmp_path, asset_dir, "--quant-type", "int8",
                          "--max-tokens", "16",
                          download_from=asset_dir, monkeypatch=monkeypatch)
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "ALL STAGES PASSED" in text
    assert all(v["ok"] for v in report.values()), report
    # stage 1 fetched the five files through the port's downloader
    for f in download.MODEL_FILES:
        assert (tmp_path / "model" / f).read_bytes() == \
            (asset_dir / f).read_bytes(), f
    assert report["files_present"]["missing"] == []
    # the JAX tool's stage names, in its order, with its fields
    fields, order = jax_stage_fields()
    assert list(report) == order
    for name, v in report.items():
        assert set(v) - {"ok"} == fields[name] - {"error"}, name
    assert report["lm_shape_class"]["matches_pinned_flagship"] is False
    assert report["lm_shape_class"]["n_layer"] == 2
    assert 0.0 <= report["cached_speaker_ab"]["speaker_token_overlap"] <= 1
    assert report["continuous_replay"]["mismatched_seeds"] == []
    devs = report["streaming_replay"]["max_abs_dev"]
    assert set(devs) == {"exact", "low", "ultra", "flash"}
    assert devs["exact"] <= 1e-3
    # the stage seconds beside the report, one per stage
    secs = json.loads((out / "stage_seconds.json").read_text())
    assert list(secs) == order and all(s >= 0 for s in secs.values())
    wav, sr, ch = read_wav((out / "normal_seed42.wav").read_bytes())
    assert sr == 16000 and ch == 1 and np.isfinite(wav).all()
    # the raw draws of parity_tokens.json: the JAX tool's formula over the
    # JAX package's RNG
    from rwkv_tts_tpu import constants as JC
    from rwkv_tts_tpu.utils.rustrng import RustStdRng as JRng
    cap = json.loads((out / "parity_tokens.json").read_text())
    assert cap["quant"] == "int8" and sorted(cap["seeds"]) == ["0", "42"]
    for seed, v in cap["seeds"].items():
        assert v["expected_raw_draws"] == V.expected_raw_draws(
            int(seed), JC, JRng)
        assert len(v["global"]) == 32


def test_quick_preset_stops_after_the_first_synthesis(asset_dir, tmp_path,
                                                      capsys):
    rc, report, _ = run(tmp_path, asset_dir, "--no-download", "--quick")
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "QUICK PRESET PASSED" in text
    assert list(report) == ["files_present", "lm_shape_class",
                            "pipeline_load", "normal_synth"]
    assert report["normal_synth"]["ok"]
    assert report["normal_synth"]["semantic_tokens"] <= 8
    assert "parity_capture" not in report
    assert "continuous_replay" not in report


def test_missing_files_stop_at_the_first_stage(asset_dir, tmp_path,
                                               monkeypatch, capsys):
    """An empty directory and a mirror without the files: stage 1 fails,
    the run stops there with exit code 1."""
    monkeypatch.setenv("HF_ENDPOINT", f"file://{tmp_path}/empty")
    out = tmp_path / "out"
    rc = V.main(["--model-dir", str(tmp_path / "model"), "--out", str(out)],
                device="cpu")
    assert rc == 1
    report = json.loads((out / "report.json").read_text())
    assert list(report) == ["files_present"]
    assert report["files_present"]["missing"] == list(download.MODEL_FILES)
    assert "cannot continue" in capsys.readouterr().out


def test_parity_capture_equals_the_jax_engine(asset_dir, tmp_path):
    """``--quant-type none``, 8 tokens: the capture's tokens for seed 42
    are the JAX ``ReferenceRngEngine``'s on the same files, exactly."""
    from rwkv_tts_tpu.config import EngineConfig as JEngineConfig
    from rwkv_tts_tpu.config import TtsArgs as JArgs
    from rwkv_tts_tpu.models.convert import load_rwkv7 as jload
    from rwkv_tts_tpu.runtime.engine import TtsEngine as JEngine
    from rwkv_tts_tpu.runtime.parity import ReferenceRngEngine as JRef

    rc, report, out = run(tmp_path, asset_dir, "--no-download",
                          "--quant-type", "none", "--max-tokens", "8")
    assert report["parity_capture"]["ok"], report
    cap = json.loads((out / "parity_tokens.json").read_text())
    params, cfg = jload(str(asset_dir / "webrwkv.safetensors"),
                        dtype="bfloat16")
    jeng = JRef(JEngine(params, cfg, JEngineConfig(
        prefill_buckets=(64, 128), max_semantic_tokens=8), use_pallas=False))
    want = jeng.generate(JArgs(text=cap["text"], seed=42, max_tokens=8))
    assert cap["seeds"]["42"]["global"] == want.global_tokens
    assert cap["seeds"]["42"]["semantic"] == want.semantic_tokens


@pytest.mark.parametrize("a,b", [
    ([1, 2, 3, 3] + [0] * 28, [3, 3, 2, 9] + [0] * 28),
    (list(range(32)), list(range(31, -1, -1))),
    ([5] * 32, [6] * 32)])
def test_token_overlap_matches_the_jax_tool(jax_tool, a, b):
    assert V._token_overlap(a, b) == jax_tool._token_overlap(a, b)


@pytest.mark.parametrize("n", [800, 4000, 16000])
def test_logmel_l1_matches_the_jax_tool(jax_tool, n):
    rng = np.random.default_rng(n)
    a = (0.3 * rng.standard_normal(n)).astype(np.float32)
    b = (a + 0.05 * rng.standard_normal(n)).astype(np.float32)
    got, want = V._logmel_l1(a, b), jax_tool._logmel_l1(a, b)
    assert (np.isnan(got) and np.isnan(want)) or got == want


def test_codecs_are_served_by_the_exports(asset_dir):
    """The published layout has no BiCodec state dict: the loader serves
    the graphs, as the validator's stages then use them."""
    bc, _ = codec_loader.load_bicodec(str(asset_dir), device="cpu")
    assert isinstance(bc, bicodec.OnnxBiCodec)
    w2v, _, _ = codec_loader.load_w2v(str(asset_dir), device="cpu")
    assert isinstance(w2v, wav2vec2.OnnxWav2Vec2)

"""The PyTorch port stands alone: nothing under ``rwkv_tts_tpu_torch/`` and
not ``chip_smoke.py`` imports JAX, aiohttp, ml_dtypes, onnx, onnxruntime
or the JAX package; the package imports with no JAX, no aiohttp, no nvcc
and no card; entry points refuse
to run on the CPU unless asked, and a kernel wrapper never gives way to its
plain version on another device; its own copies of host-only modules (the
server's UI page among them) equal the originals."""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "rwkv_tts_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "rwkv_tts_tpu", "aiohttp", "ml_dtypes",
             "onnx", "onnxruntime")


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_imports(path):
    for mod in imported_modules(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path}: imports {mod}"


def _run(code, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_package_imports_without_jax_nvcc_or_card(tmp_path):
    """Every module imports with JAX and aiohttp made unimportable and no
    nvcc on PATH, and none pulls in the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['aiohttp'] = None\n"
        "sys.modules['rwkv_tts_tpu'] = None\n"
        "import rwkv_tts_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('imported')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    env.pop("CUDA_HOME", None)
    out = _run(code, env=env)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_server_and_cli_import_without_jax_or_aiohttp():
    """The server and the CLI are the standard library's: both import, and
    the server's module builds an app class, with JAX, aiohttp and the JAX
    package unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'aiohttp', 'rwkv_tts_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import rwkv_tts_tpu_torch.server.app as a\n"
        "import rwkv_tts_tpu_torch.cli as c\n"
        "import rwkv_tts_tpu_torch.runtime.batching as b\n"
        "import rwkv_tts_tpu_torch.audio.mp3 as m\n"
        "assert callable(a.create_app) and callable(c.main)\n"
        "assert not any(k.split('.')[0] in ('jax', 'aiohttp') and v\n"
        "               for k, v in sys.modules.items())\n"
        "print('imported')\n")
    out = _run(code, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_entry_points_refuse_the_cpu_without_asking(no_card):
    import numpy as np

    from rwkv_tts_tpu_torch.config import (BiCodecConfig, EngineConfig,
                                           RwkvConfig, TtsArgs,
                                           Wav2Vec2Config)
    from rwkv_tts_tpu_torch.models import (bicodec, codec_loader, convert,
                                           rwkv7, wav2vec2)
    from rwkv_tts_tpu_torch.models.onnx_graph import OnnxGraph
    from rwkv_tts_tpu_torch.ops.conv1d import conv1d
    from rwkv_tts_tpu_torch.runtime.continuous import ContinuousEngine
    from rwkv_tts_tpu_torch.runtime.engine import TtsEngine
    from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline
    from rwkv_tts_tpu_torch.runtime.streaming import stream_synthesize
    from rwkv_tts_tpu_torch.server import app as server_app
    from rwkv_tts_tpu_torch.tools import (profile_prefill_pieces,
                                          profile_stack_kernel,
                                          profile_step_pieces,
                                          validate_real_assets)
    from rwkv_tts_tpu_torch.utils import bridge

    cfg = RwkvConfig(n_layer=1, n_embd=64, vocab_size=300,
                     padded_vocab_size=384, decay_lora=8, a_lora=8,
                     v_lora=8, gate_lora=8, dtype="float32",
                     param_dtype="float32")
    bcfg = BiCodecConfig.tiny()
    wcfg = Wav2Vec2Config(num_layers=1, hidden_size=32, num_heads=2,
                          ffn_size=32, conv_dims=(16,) * 7)
    lm = rwkv7.init_params(cfg, device="cpu")
    bc = bicodec.init_params(bcfg, device="cpu")
    w2v = wav2vec2.init_params(wcfg, device="cpu")
    wav = np.zeros((1, 4000), np.float32)
    for call in (lambda: TtsPipeline(lm, cfg, bc, bcfg),
                 lambda: TtsPipeline(lm, cfg, bc, bcfg, w2v, wcfg),
                 lambda: TtsPipeline(lm, cfg, bc, bcfg,
                                     codec_conv_impl="mxu_fused"),
                 lambda: TtsEngine(lm, cfg, EngineConfig()),
                 lambda: ContinuousEngine(lm, cfg, EngineConfig()),
                 lambda: ContinuousEngine(lm, cfg, EngineConfig(), slots=2,
                                          buckets=()),
                 lambda: next(stream_synthesize(
                     ContinuousEngine(lm, cfg, EngineConfig()), bc, bcfg,
                     TtsArgs(text="x"))),
                 lambda: bridge.continuous_state({}, np.zeros(1), {}),
                 lambda: rwkv7.init_params(cfg),
                 lambda: rwkv7.init_state(cfg, 1),
                 lambda: rwkv7.make_serving_params(cfg),
                 lambda: bicodec.init_params(bcfg),
                 lambda: bicodec.encode(bc, np.zeros((1, 8, 1024), np.float32),
                                        np.zeros((1, 128, 301), np.float32),
                                        bcfg),
                 lambda: wav2vec2.init_params(wcfg),
                 lambda: wav2vec2.extract_features(w2v, wav, wcfg),
                 lambda: bridge.rwkv7_params({"blocks": {}}),
                 lambda: bridge.bicodec_params({}),
                 lambda: bridge.wav2vec2_params({}),
                 lambda: profile_stack_kernel.main([]),
                 lambda: profile_step_pieces.main([]),
                 lambda: profile_prefill_pieces.main([]),
                 lambda: validate_real_assets.main([]),
                 lambda: server_app.build_dev_pipeline(),
                 lambda: server_app.device_from_env(),
                 lambda: convert.load_rwkv7("absent.safetensors"),
                 lambda: convert.load_checkpoint("absent.npz"),
                 lambda: convert.load_wav2vec2_weights({}, wcfg),
                 lambda: convert.load_bicodec_weights({}, bcfg),
                 lambda: OnnxGraph(b""),
                 lambda: bicodec.OnnxBiCodec(),
                 lambda: wav2vec2.OnnxWav2Vec2(None),
                 lambda: codec_loader.load_bicodec("absent"),
                 lambda: codec_loader.load_w2v("absent"),
                 lambda: codec_loader.load_codecs("absent"),
                 lambda: TtsPipeline.from_checkpoints("absent")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_card_device_keeps_float32_and_deterministic_cudnn(monkeypatch):
    """``resolve_device("cuda")`` switches TF32 off and keeps cuDNN to
    deterministic algorithms (a seeded request then gives the same audio
    twice: the vocoder's transposed convolutions otherwise may get an
    algorithm that adds with atomics). The CPU leaves the flags alone."""
    from rwkv_tts_tpu_torch.utils.device import resolve_device

    flags = (torch.backends.cuda.matmul, "allow_tf32"), \
        (torch.backends.cudnn, "allow_tf32"), \
        (torch.backends.cudnn, "deterministic")
    for mod, name in flags:
        monkeypatch.setattr(mod, name, name == "allow_tf32")
    assert resolve_device("cpu").type == "cpu"
    assert [getattr(m, n) for m, n in flags] == [True, True, False]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None).type == "cuda"
    assert [getattr(m, n) for m, n in flags] == [False, False, True]


def test_conv1d_has_no_quiet_fallback(no_card, tmp_path, monkeypatch):
    """``conv1d`` picks its path by where the tensors lie: the plain
    version on the CPU, the kernel on a card. It refuses any other device
    instead of computing somewhere else, and where the kernel cannot be
    built (no nvcc) loading it raises instead of giving way to the plain
    version."""
    from rwkv_tts_tpu_torch.ops import _build
    from rwkv_tts_tpu_torch.ops import conv1d as C

    x, w = torch.zeros(1, 96, 32), torch.zeros(96, 96, 7)
    assert C.conv1d(x, w, padding=3).shape == (1, 96, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        C.conv1d(x.to("meta"), w.to("meta"), padding=3)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(C, "_fn", None)
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            C._kernel()


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_phases_argument():
    """``--phases`` picks a subset in the script's order; no option means
    every phase (and the ok line); an unknown or empty name fails before
    anything touches a card."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert chip_smoke.parse_phases([]) is None
    assert chip_smoke.parse_phases(["--phases", "quantized,quant_kernels"]) \
        == ["quant_kernels", "quantized"]
    assert chip_smoke.parse_phases(["--phases", ",".join(
        chip_smoke.PHASES)]) == list(chip_smoke.PHASES)
    for bad in (["--phases", "kernels,bogus"], ["--phases", ","],
                ["--bogus"]):
        with pytest.raises(SystemExit) as e:
            chip_smoke.parse_phases(bad)
        assert e.value.code != 0


def test_chip_smoke_partial_run_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                          "quant_kernels"], cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"partial"' not in out.stdout


def test_constants_copy_matches_jax_package():
    pytest.importorskip("jax")
    from rwkv_tts_tpu import constants as J

    from rwkv_tts_tpu_torch import constants as P
    names = {n for n in dir(J) if n.isupper()}
    assert names == {n for n in dir(P) if n.isupper()}
    for n in names:
        assert getattr(P, n) == getattr(J, n), n


def test_config_copies_match_jax_package():
    pytest.importorskip("jax")
    from rwkv_tts_tpu import config as J

    from rwkv_tts_tpu_torch import config as P
    for name in ("RwkvConfig", "SamplingConfig", "EngineConfig",
                 "Wav2Vec2Config", "BiCodecConfig", "TtsArgs"):
        mine = dataclasses.asdict(getattr(P, name)())
        theirs = dataclasses.asdict(getattr(J, name)())
        assert {k: v for k, v in theirs.items() if k in mine} == mine, name
    assert dataclasses.asdict(P.BiCodecConfig.tiny()) == \
        dataclasses.asdict(J.BiCodecConfig.tiny())
    # the fields this slice reads are there, with the JAX defaults
    assert P.BiCodecConfig().conv_impl == J.BiCodecConfig().conv_impl \
        == "native"
    assert P.TtsArgs().cached_speaker is J.TtsArgs().cached_speaker is None


def test_metrics_copy_matches_jax_package():
    """``utils/metrics`` is the port's own copy of the host-only histogram:
    the same buckets, and the same exposition text for the same
    observations (NaN and infinities dropped)."""
    pytest.importorskip("jax")
    from rwkv_tts_tpu.utils import metrics as J

    from rwkv_tts_tpu_torch.utils import metrics as P
    assert P.STAGE_BUCKETS == J.STAGE_BUCKETS
    values = [0.0, 0.004, 0.01, 0.0100001, 0.3, 0.4, 1.7, 19.9, 20.0, 25.0,
              float("nan"), float("inf"), -float("inf"), -1.0]
    for buckets, help_text in ((P.STAGE_BUCKETS, "submit() to admission"),
                               ((5.0, 0.5, 1.0), "")):
        mine = P.Histogram("stage_seconds", buckets, help_text)
        theirs = J.Histogram("stage_seconds", buckets, help_text)
        assert mine.render() == theirs.render()
        for v in values:
            mine.observe(v)
            theirs.observe(v)
        assert mine.render() == theirs.render()
        assert (mine.n, mine.total, mine.counts) == \
            (theirs.n, theirs.total, theirs.counts)


def test_property_tables_match_jax_package():
    pytest.importorskip("jax")
    from rwkv_tts_tpu.tokenizer import properties as J

    from rwkv_tts_tpu_torch.tokenizer import properties as P
    for table in ("SPEED_MAP", "PITCH_MAP", "AGE_MAP", "GENDER_MAP",
                  "EMOTION_MAP"):
        assert getattr(P, table) == getattr(J, table)


def test_tokenizer_copy_matches_jax_package():
    pytest.importorskip("jax")
    from rwkv_tts_tpu.tokenizer import load_tokenizer as jload

    from rwkv_tts_tpu_torch.tokenizer import load_tokenizer
    texts = ["Hello, world!", "你好，世界。", "emoji 🎉 and ünïcödé",
             "  tabs\tand\nnewlines ", "12345 67.89", ""]
    mine, theirs = load_tokenizer(), jload()
    for text in texts:
        assert mine.encode(text) == theirs.encode(text), text
        assert mine.decode(mine.encode(text)) == text


def test_server_copies_match_jax_package():
    """The server's copied pieces: the UI page byte for byte, the latency
    and RTF buckets, ``coerce_speed``'s thresholds, and the ``BatchConfig``
    and ``ServerConfig`` defaults."""
    pytest.importorskip("jax")
    pytest.importorskip("aiohttp")
    from rwkv_tts_tpu import config as JC
    from rwkv_tts_tpu.server import app as JA
    from rwkv_tts_tpu.utils import metrics as JM

    from rwkv_tts_tpu_torch import config as PC
    from rwkv_tts_tpu_torch.server import app as PA
    from rwkv_tts_tpu_torch.utils import metrics as PM
    page = "server/static/index.html"
    assert (ROOT / "rwkv_tts_tpu_torch" / page).read_bytes() == \
        (ROOT / "rwkv_tts_tpu" / page).read_bytes()
    assert PA.STATIC_DIR != JA.STATIC_DIR
    assert PM.LATENCY_BUCKETS == JM.LATENCY_BUCKETS
    assert PM.RTF_BUCKETS == JM.RTF_BUCKETS
    for x in [None, "slow", "nope"] + [round(2.0 + 0.01 * i, 2)
                                       for i in range(400)]:
        assert PA.coerce_speed(x) == JA.coerce_speed(x), x
    for name in ("BatchConfig", "ServerConfig"):
        assert dataclasses.asdict(getattr(PC, name)()) == \
            dataclasses.asdict(getattr(JC, name)()), name

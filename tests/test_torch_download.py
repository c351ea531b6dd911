"""The port's start-up download (``rwkv_tts_tpu_torch/utils/download.py``)
held against the JAX package's module: the same constants, the JAX tests'
three cases, the same bytes from one ``file://`` mirror, the same soft
failure, the endpoint order, the next mirror tried after a body cut short,
the whole-file deadline, and the server's wiring (``--no-download`` gates
the check, which comes before the ``--tp`` check). The public mirrors are
patched out of both modules in every test: nothing leaves the machine."""

import http.client
import os
import urllib.request

import numpy as np
import pytest

from rwkv_tts_tpu.utils import download as jax_dl
from rwkv_tts_tpu_torch.server import app as A
from rwkv_tts_tpu_torch.utils import download as dl

MODULES = {"jax": jax_dl, "port": dl}
PUBLIC_MIRRORS = {name: mod.MIRRORS for name, mod in MODULES.items()}


@pytest.fixture(autouse=True)
def no_public_mirrors(monkeypatch):
    monkeypatch.delenv("HF_ENDPOINT", raising=False)
    for mod in MODULES.values():
        monkeypatch.setattr(mod, "MIRRORS", ())


def mirror(tmp_path, files):
    """A published-layout mirror under ``tmp_path/hub``; returns its
    ``file://`` endpoint."""
    repo = tmp_path / "hub" / "cgisky" / "rwkv-tts" / "resolve" / "main"
    repo.mkdir(parents=True, exist_ok=True)
    for name, data in files.items():
        (repo / name).write_bytes(data)
    return f"file://{tmp_path}/hub"


def test_constants_match_jax_package():
    for name in ("HF_REPO", "MODEL_FILES", "TIMEOUT_S"):
        assert getattr(dl, name) == getattr(jax_dl, name), name
    # the modules' own values, read before the fixture patched them out
    assert PUBLIC_MIRRORS["jax"] == PUBLIC_MIRRORS["port"] == (
        "https://huggingface.co", "https://hf-mirror.com")


def test_missing_files(tmp_path):
    d = str(tmp_path / "model")
    assert set(dl.missing_files(d)) == set(dl.MODEL_FILES)
    os.makedirs(d)
    (tmp_path / "model" / "tokenizer.json").write_text("{}")
    assert "tokenizer.json" not in dl.missing_files(d)
    assert dl.missing_files(d) == jax_dl.missing_files(d)


def test_download_via_local_endpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_ENDPOINT",
                       mirror(tmp_path, {"tokenizer.json": b'{"1": "x"}'}))
    dest = str(tmp_path / "model")
    assert dl.download_file(dest, "tokenizer.json")
    assert (tmp_path / "model" / "tokenizer.json").read_bytes() == \
        b'{"1": "x"}'


def test_ensure_models_soft_failure(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_ENDPOINT", f"file://{tmp_path}/empty")
    still = dl.ensure_models(str(tmp_path / "model"),
                             files=("webrwkv.safetensors",), required=False,
                             timeout=3.0)
    assert still == ["webrwkv.safetensors"]
    with pytest.raises(FileNotFoundError):
        dl.ensure_models(str(tmp_path / "model"),
                         files=("webrwkv.safetensors",), required=True,
                         timeout=3.0)


def test_both_modules_fetch_the_same_bytes(tmp_path, monkeypatch):
    """Every published file from one mirror, through each module into a
    directory of its own: equal bytes, nothing left missing, no temp file
    left behind."""
    rng = np.random.default_rng(0)
    files = {f: rng.bytes(int(n)) for f, n in zip(
        dl.MODEL_FILES, (3 << 20 | 5, 1000, 1 << 20, 7, 0))}
    monkeypatch.setenv("HF_ENDPOINT", mirror(tmp_path, files))
    for name, mod in MODULES.items():
        d = tmp_path / name
        assert mod.ensure_models(str(d)) == []
        assert sorted(os.listdir(d)) == sorted(files)
        for f, data in files.items():
            assert (d / f).read_bytes() == data, (name, f)
    assert mod.ensure_models(str(d)) == []        # nothing left to fetch


@pytest.mark.parametrize("name", sorted(MODULES))
def test_missing_file_fails_soft(tmp_path, monkeypatch, name):
    mod = MODULES[name]
    monkeypatch.setenv("HF_ENDPOINT",
                       mirror(tmp_path, {"tokenizer.json": b"{}"}))
    d = tmp_path / "model"
    still = mod.ensure_models(str(d), timeout=3.0)
    assert still == [f for f in mod.MODEL_FILES if f != "tokenizer.json"]
    assert os.listdir(d) == ["tokenizer.json"]     # no .part file left


@pytest.mark.parametrize("env", [None, "file:///x/hub/"])
def test_endpoint_order(monkeypatch, env):
    """``HF_ENDPOINT`` first (its trailing slash cut), then the mirrors,
    each once."""
    monkeypatch.setattr(dl, "MIRRORS", ("https://a.example", "file:///x/hub"))
    if env:
        monkeypatch.setenv("HF_ENDPOINT", env)
    want = (["file:///x/hub", "https://a.example"] if env else
            ["https://a.example", "file:///x/hub"])
    assert dl.endpoints() == want


@pytest.mark.parametrize("name", sorted(MODULES))
def test_a_body_cut_short_tries_the_next_mirror(tmp_path, monkeypatch,
                                                name):
    """``http.client.HTTPException`` (``IncompleteRead``) from the first
    endpoint: the next one is tried, and the file published whole."""
    mod = MODULES[name]
    good = mirror(tmp_path, {"tokenizer.json": b"whole"})
    monkeypatch.setattr(mod, "MIRRORS", ("file:///cut", good))
    real = urllib.request.urlopen
    tried = []

    def urlopen(req, timeout=None):
        tried.append(req.full_url)
        if req.full_url.startswith("file:///cut"):
            raise http.client.IncompleteRead(b"par", 5)
        return real(req, timeout=timeout)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    d = tmp_path / "model"
    assert mod.download_file(str(d), "tokenizer.json")
    assert (d / "tokenizer.json").read_bytes() == b"whole"
    assert [u.split("/cgisky")[0] for u in tried] == ["file:///cut", good]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_whole_file_deadline(tmp_path, monkeypatch, name):
    """A deadline already past: the first 1 MiB read ends the attempt, no
    file and no temp file is left."""
    mod = MODULES[name]
    monkeypatch.setenv("HF_ENDPOINT", mirror(
        tmp_path, {"webrwkv.safetensors": b"\0" * (2 << 20)}))
    d = tmp_path / "model"
    assert not mod.download_file(str(d), "webrwkv.safetensors", timeout=-1.0)
    assert os.listdir(d) == []


def test_server_start_up_downloads_unless_told_not_to(tmp_path,
                                                      monkeypatch):
    """``build_pipeline_from_args`` calls ``ensure_models`` on the
    checkpoint's directory first, unless ``--no-download``, as the JAX
    server does (tests/test_server.py holds it there): before the ``--tp``
    check, so a server that exits on ``--tp`` has already looked."""
    monkeypatch.setenv("RWKV_TTS_PLATFORM", "cpu")
    calls = []
    monkeypatch.setattr(dl, "ensure_models",
                        lambda model_dir, **kw: calls.append(model_dir) or [])

    def args(*extra):
        return A.parse_args(["--model-path",
                             str(tmp_path / "absent.safetensors"),
                             "--raf-dir", str(tmp_path / "raf"),
                             *extra])

    with pytest.raises(SystemExit, match="does not divide"):
        A.build_pipeline_from_args(args("--tp", "2"))
    assert calls == [str(tmp_path)]
    with pytest.raises(SystemExit, match="does not divide"):
        A.build_pipeline_from_args(args("--tp", "2", "--no-download"))
    assert calls == [str(tmp_path)]
    # a bare file name: the published directory
    with pytest.raises(SystemExit, match="does not divide"):
        A.build_pipeline_from_args(A.parse_args(
            ["--model-path", "webrwkv.safetensors", "--tp", "2"]))
    assert calls == [str(tmp_path), "assets/model"]


def test_server_fetches_from_a_mirror_and_loads(tmp_path, monkeypatch):
    """The real check on an empty model directory: the mirror's files are
    fetched before the model is resolved (here only the tokenizer, so the
    server serves dev weights), and the fetched file is the mirror's."""
    monkeypatch.setenv("RWKV_TTS_PLATFORM", "cpu")
    tok = b'{"0": "x"}'
    monkeypatch.setenv("HF_ENDPOINT",
                       mirror(tmp_path, {"tokenizer.json": tok}))
    model = tmp_path / "model"
    with pytest.raises(SystemExit, match="does not divide"):
        A.build_pipeline_from_args(A.parse_args(
            ["--model-path", str(model / "webrwkv.safetensors"),
             "--raf-dir", str(tmp_path / "raf"), "--tp", "2"]))
    assert os.listdir(model) == ["tokenizer.json"]
    assert (model / "tokenizer.json").read_bytes() == tok

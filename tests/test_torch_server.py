"""The port's HTTP server (``rwkv_tts_tpu_torch.server.app``) against the
JAX app (``rwkv_tts_tpu.server.app``) route by route, on the CPU, at the
toy shape of tests/test_server.py (LM 2 × 128, ``BiCodecConfig.tiny(
feat_dim=32)``, a 2-layer wav2vec2), with the same parameters on both sides
through ``utils/bridge``. The JAX app runs under aiohttp's ``TestServer``
on an event loop in a thread, the port's server on a loopback socket; both
are driven with ``http.client`` (``chip_smoke.http_call``).

Every contract of tests/test_server.py holds for the port; for the same
seeded request the port's WAV has the JAX WAV's length exactly (the tokens
are the same) and its samples agree within 1e-3 (the BiCodec chain's f32
gap, tests/test_torch_bicodec.py); status codes and body keys match route
by route."""

import asyncio
import base64
import contextlib
import http.client
import json
import re
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.audio.io import encode_wav_16bit, read_wav
from rwkv_tts_tpu_torch.config import (BatchConfig, BiCodecConfig,
                                       EngineConfig, RwkvConfig, TtsArgs,
                                       Wav2Vec2Config)
from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline
from rwkv_tts_tpu_torch.runtime.voice_store import VoiceStore
from rwkv_tts_tpu_torch.server import app as P
from rwkv_tts_tpu_torch.utils import bridge

http_call, http_stream = chip_smoke.http_call, chip_smoke.http_stream


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LM = dict(n_layer=2, n_embd=128, head_size=64, vocab_size=77923,
          padded_vocab_size=78080, decay_lora=32, a_lora=32, v_lora=16,
          gate_lora=32, dtype="float32", param_dtype="float32")
W2V = dict(num_layers=2, hidden_size=32, num_heads=2, ffn_size=64,
           conv_dims=(16,) * 7)
ECFG = dict(prefill_buckets=(32, 64, 128), max_semantic_tokens=16,
            batch_size=2)
BATCH = BatchConfig(max_batch_size=4, collect_timeout_ms=5,
                    inference_timeout_ms=120000)
CORS = {"access-control-allow-origin": "*",
        "access-control-allow-methods": "GET, POST, OPTIONS",
        "access-control-allow-headers": "Content-Type"}


@pytest.fixture(scope="module")
def jax_weights():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import BiCodecConfig as JB
    from rwkv_tts_tpu.config import RwkvConfig as JR
    from rwkv_tts_tpu.config import Wav2Vec2Config as JW
    from rwkv_tts_tpu.models import bicodec, rwkv7, wav2vec2

    key = jax.random.PRNGKey(0)
    return (rwkv7.init_params(JR(**LM), key),
            bicodec.init_params(JB.tiny(feat_dim=32), key),
            wav2vec2.init_params(JW(**W2V), key))


def port_pipeline(jax_weights, raf_dir, **engine) -> TtsPipeline:
    lm, bc, w2v = jax_weights
    return TtsPipeline(
        bridge.rwkv7_params(lm, "cpu"), RwkvConfig(**LM),
        bridge.bicodec_params(bc, "cpu"), BiCodecConfig.tiny(feat_dim=32),
        bridge.wav2vec2_params(w2v, "cpu"), Wav2Vec2Config(**W2V),
        voice_store=None if raf_dir is None else VoiceStore(str(raf_dir)),
        engine_cfg=EngineConfig(**dict(ECFG, **engine)),
        w2v_output_layers=(1, 2), device="cpu")


@contextlib.contextmanager
def serving(app):
    """The port's app on a loopback port; closed on exit as ``main``
    closes it."""
    srv = P.make_server(app, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()
        t.join(timeout=30)


@contextlib.contextmanager
def port_server(jax_weights, tmp_path, **app_kw):
    with serving(P.create_app(port_pipeline(jax_weights, tmp_path), BATCH,
                              **app_kw)) as port:
        yield port


class JaxServer:
    """The JAX app under aiohttp's TestServer, on an event loop of its own
    thread."""

    def __init__(self, app):
        from aiohttp.test_utils import TestServer

        self.app = app
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.server = TestServer(app, host="127.0.0.1")
        self._run(self.server.start_server())
        self.port = self.server.port

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(300)

    def close(self):
        self._run(self.server.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        self.loop.close()


@pytest.fixture(scope="module")
def both(jax_weights, tmp_path_factory):
    """(JAX port, the port's port): one server each over the same weights,
    each with a voice store of its own."""
    from rwkv_tts_tpu.config import BatchConfig as JBatch
    from rwkv_tts_tpu.config import BiCodecConfig as JB
    from rwkv_tts_tpu.config import EngineConfig as JE
    from rwkv_tts_tpu.config import RwkvConfig as JR
    from rwkv_tts_tpu.config import Wav2Vec2Config as JW
    from rwkv_tts_tpu.runtime.pipeline import TtsPipeline as JPipeline
    from rwkv_tts_tpu.runtime.voice_store import VoiceStore as JStore
    from rwkv_tts_tpu.server.app import create_app as jcreate

    lm, bc, w2v = jax_weights
    jpipe = JPipeline(lm, JR(**LM), bc, JB.tiny(feat_dim=32), w2v, JW(**W2V),
                      voice_store=JStore(str(tmp_path_factory.mktemp("jraf"))),
                      engine_cfg=JE(**ECFG), use_pallas=False,
                      w2v_output_layers=(1, 2))
    jsrv = JaxServer(jcreate(jpipe, JBatch(**dataclass_fields(BATCH))))
    try:
        with port_server(jax_weights, tmp_path_factory.mktemp("praf")) as p:
            yield jsrv.port, p
    finally:
        jsrv.close()


def dataclass_fields(obj) -> dict:
    return {f: getattr(obj, f) for f in obj.__dataclass_fields__}


def call_both(both, method, path, body=None, headers=None):
    """The same request to both servers: [(status, headers, body)] JAX
    first."""
    return [http_call(p, method, path, body, headers) for p in both]


def keys(body: bytes):
    return sorted(json.loads(body))


def wav_samples(body: bytes) -> np.ndarray:
    wav, sr, ch = read_wav(base64.b64decode(json.loads(body)["audio_base64"]))
    assert sr == 16000 and ch == 1 and len(wav) > 0
    return wav


def stream_pcm(lines) -> np.ndarray:
    pcm = b"".join(base64.b64decode(ln["audio_base64"]) for ln in lines)
    assert len(pcm) % 2 == 0 and len(pcm) > 0
    return np.frombuffer(pcm, "<i2").astype(np.float32) / 32767.0


# --------------------------------------------------------------------------
# route by route against the JAX app
# --------------------------------------------------------------------------

def test_tts_endpoint(both):
    (js, _, jb), (ps, _, pb) = call_both(
        both, "POST", "/api/tts", {"text": "hello world", "seed": 42,
                                   "speed": 4.2})
    assert js == ps == 200
    assert keys(jb) == keys(pb)
    pj = json.loads(pb)
    assert pj["success"] is True and pj["rtf"] > 0
    assert set(pj["timings_ms"]) == set(json.loads(jb)["timings_ms"])
    want, got = wav_samples(jb), wav_samples(pb)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_tts_missing_text(both):
    for body in ({"seed": 1}, b"{not json", {"text": "   "}):
        (js, _, jb), (ps, _, pb) = call_both(both, "POST", "/api/tts", body)
        assert js == ps == 400
        assert json.loads(pb) == json.loads(jb)
        assert json.loads(pb)["success"] is False


def test_bad_parameter_types_and_healthz(both):
    for body in ({"text": "x", "temperature": "abc"},
                 {"text": "x", "seed": "zzz"}):
        (js, _, jb), (ps, _, pb) = call_both(both, "POST", "/api/tts", body)
        assert js == ps == 400
        assert json.loads(pb) == json.loads(jb)
        assert "invalid parameter" in json.loads(pb)["error"]
    (js, _, jb), (ps, _, pb) = call_both(both, "GET", "/healthz")
    assert js == ps == 200 and keys(jb) == keys(pb)
    j, p = json.loads(jb), json.loads(pb)
    assert p["status"] == "ok" and p["model"] == j["model"]
    assert p["model"]["n_layer"] == 2 and p["tts_engine"] == "continuous"


def test_streaming_endpoint(both):
    """A stream's lines are in order with one final line last and carry
    the JAX app's keys; its PCM has the samples of the same seeded
    /api/tts WAV (and of the JAX stream), correlated with the WAV."""
    req = {"text": "stream over http", "seed": 2}
    runs = [http_stream(p, req) for p in both]
    for status, lines, _, _ in runs:
        assert status == 200 and lines and lines[-1]["final"] is True
        assert [ln["seq"] for ln in lines] == list(range(len(lines)))
    (_, jlines, _, _), (_, plines, _, _) = runs
    assert [sorted(ln) for ln in plines] == [sorted(ln) for ln in jlines]
    assert plines[-1]["first_chunk_ms"] > 0
    pcm = stream_pcm(plines)
    assert len(pcm) == len(stream_pcm(jlines))
    status, _, body = http_call(both[1], "POST", "/api/tts", req)
    wav = wav_samples(body)
    assert len(pcm) == len(wav)
    assert np.corrcoef(pcm, wav)[0, 1] > 0.99


def test_streaming_ultra_latency_mode(both):
    for mode in ("ultra", "flash"):
        _, lines, _, _ = http_stream(both[1], {"text": "fastest stream",
                                               "seed": 11,
                                               "latency_mode": mode})
        assert lines and lines[-1]["final"]
        assert len(stream_pcm(lines)) > 0
    # an unknown mode is refused up front, with the JAX body
    (js, _, jb), (ps, _, pb) = call_both(
        both, "POST", "/api/tts/stream", {"text": "x", "latency_mode": "warp"})
    assert js == ps == 400 and json.loads(pb) == json.loads(jb)
    for body in ({"seed": 1}, b"[]{"):
        (js, _, jb), (ps, _, pb) = call_both(both, "POST", "/api/tts/stream",
                                             body)
        assert js == ps == 400 and json.loads(pb) == json.loads(jb)


def test_voice_clone_lifecycle(both):
    """extract → list → tts with voice_id → 404 on an unknown id → delete →
    404 on a second delete, over HTTP on both servers; the same WAV
    enrolls the same tokens on both."""
    rng = np.random.default_rng(0)
    wav = rng.normal(0, 0.2, 16000 * 2).astype(np.float32)
    body, ctype = chip_smoke.multipart_body({
        "voice_name": "pytest voice", "prompt_text": "two seconds of noise",
        "audio_file": ("ref.wav", encode_wav_16bit(wav, 16000))})
    (js, _, jb), (ps, _, pb) = call_both(
        both, "POST", "/api/voice-clone/extract", body,
        {"Content-Type": ctype})
    assert js == ps == 200 and keys(jb) == keys(pb), (jb, pb)
    jvid, pvid = json.loads(jb)["voice_id"], json.loads(pb)["voice_id"]

    (js, _, jb), (ps, _, pb) = call_both(both, "GET",
                                         "/api/voice-clone/list")
    jv = [v for v in json.loads(jb)["voices"] if v["id"] == jvid]
    pv = [v for v in json.loads(pb)["voices"] if v["id"] == pvid]
    assert js == ps == 200 and len(jv) == len(pv) == 1
    assert sorted(jv[0]) == sorted(pv[0])
    for k in ("name", "prompt_text", "audio_duration", "sample_rate"):
        assert pv[0][k] == jv[0][k], k

    for p, vid in zip(both, (jvid, pvid)):
        status, _, b = http_call(p, "POST", "/api/tts",
                                 {"text": "clone", "voice_id": vid})
        assert status == 200 and json.loads(b)["success"], b
    (js, _, jb), (ps, _, pb) = call_both(both, "POST", "/api/tts",
                                         {"text": "x", "voice_id": "nope"})
    assert js == ps == 404 and json.loads(pb) == json.loads(jb)
    for vid_j, vid_p, want in ((jvid, pvid, 200), (jvid, pvid, 404)):
        js, _, jb = http_call(both[0], "POST", "/api/voice-clone/delete",
                              {"voice_id": vid_j})
        ps, _, pb = http_call(both[1], "POST", "/api/voice-clone/delete",
                              {"voice_id": vid_p})
        assert js == ps == want and keys(jb) == keys(pb)
    (js, _, jb), (ps, _, pb) = call_both(both, "POST",
                                         "/api/voice-clone/delete", {})
    assert js == ps == 400 and json.loads(pb) == json.loads(jb)


def test_voice_extract_errors_match(both):
    for fields in ({"prompt_text": "no name",
                    "audio_file": ("a.wav", b"RIFF")},
                   {"voice_name": "no audio"}):
        body, ctype = chip_smoke.multipart_body(fields)
        (js, _, jb), (ps, _, pb) = call_both(
            both, "POST", "/api/voice-clone/extract", body,
            {"Content-Type": ctype})
        assert js == ps == 400 and json.loads(pb) == json.loads(jb)
    # an unreadable clip fails the extraction, not the server
    body, ctype = chip_smoke.multipart_body({
        "voice_name": "bad clip", "audio_file": ("a.mp3", b"not audio")})
    (js, _, jb), (ps, _, pb) = call_both(
        both, "POST", "/api/voice-clone/extract", body,
        {"Content-Type": ctype})
    assert js == ps == 500 and keys(jb) == keys(pb)
    assert json.loads(pb)["error"].startswith("voice extraction failed")


def test_metrics_and_ui(both):
    (js, _, jb), (ps, ph, pb) = call_both(both, "GET", "/metrics")
    assert js == ps == 200 and ph["content-type"].startswith("text/plain")
    (js, _, jb), (ps, ph, pb) = call_both(both, "GET", "/")
    assert js == ps == 200 and pb == jb
    assert ph["content-type"].startswith("text/html")
    assert b"/api/tts" in pb
    (js, _, jb), (ps, _, pb) = call_both(both, "GET", "/index.html")
    assert js == ps == 200 and pb == jb


def test_metric_names_match(both):
    """After the same kinds of traffic, the port exposes every metric name
    the JAX app exposes."""
    for p in both:
        http_call(p, "POST", "/api/tts", {"text": "names", "seed": 3})
        http_stream(p, {"text": "names", "seed": 3})
    (_, _, jb), (_, _, pb) = call_both(both, "GET", "/metrics")

    def names(body):
        return {ln.split()[0].split("{")[0] for ln in body.decode()
                .splitlines() if ln and not ln.startswith("#")}
    assert names(jb) <= names(pb), names(jb) - names(pb)


def test_cors_404_405_and_options(both):
    """Off the routes the port answers as the JAX app's aiohttp router
    does (its static route takes GET and HEAD everywhere), with the CORS
    headers on every answer."""
    for method, path, want in (("GET", "/nope", 404),
                               ("POST", "/nope", 405),
                               ("GET", "/api/tts", 404),
                               ("POST", "/healthz", 405),
                               ("PUT", "/api/tts", 405),
                               ("POST", "/index.html", 405),
                               ("HEAD", "/", 200),
                               ("OPTIONS", "/api/tts", 200),
                               ("OPTIONS", "/anything", 200)):
        (js, jh, jb), (ps, ph, pb) = call_both(both, method, path)
        assert js == ps == want, (method, path)
        for k, v in CORS.items():
            assert jh[k] == ph[k] == v, (method, path, k)
        assert pb == jb, (method, path)
        assert jh.get("allow") == ph.get("allow"), (method, path)
    # nothing outside the static directory is served
    assert http_call(both[1], "GET", "/../rwkv_tts_tpu_torch/server/app.py"
                     )[0] == 404


def test_coerce_speed():
    from rwkv_tts_tpu.server.app import coerce_speed as J

    # thresholds from bin/server.rs:528-554 (differ from classify_speed!)
    assert P.coerce_speed(3.4) == "very_slow"
    assert P.coerce_speed(4.0) == "slow"
    assert P.coerce_speed(4.5) == "medium"
    assert P.coerce_speed(4.8) == "fast"
    assert P.coerce_speed(5.0) == "very_fast"
    for v in (None, "fast", "bogus", "", 0, -1, 3.39, 3.41, 4.01, 4.49,
              4.51, 4.79, 4.81, 100, "4.2", [1], float("nan"), True):
        assert P.coerce_speed(v) == J(v), v


def test_build_tts_args_matches_jax():
    from rwkv_tts_tpu.server.app import build_tts_args as J

    for payload in ({"text": "x"},
                    {"text": "y", "seed": "7", "speed": 4.6, "top_p": 0,
                     "temperature": None, "voice_id": "", "age": "child",
                     "cached_speaker": 0, "prompt_text": None},
                    {"text": "z", "gender": "male", "emotion": "SAD",
                     "pitch": "high_pitch", "cached_speaker": True}):
        assert dataclass_fields(P.build_tts_args(payload)) == \
            dataclass_fields(J(payload))


def test_with_token_chunk_shapes_prefill_buckets():
    from rwkv_tts_tpu.config import EngineConfig as J

    e = EngineConfig().with_token_chunk(256)
    assert e.prefill_buckets == (64, 128, 256)
    e = EngineConfig().with_token_chunk(100)
    assert e.prefill_buckets == (64, 100)
    assert EngineConfig().with_token_chunk(4096).prefill_buckets[-1] == 4096
    assert EngineConfig().with_token_chunk(1).prefill_buckets == (16,)
    for n in (1, 16, 63, 64, 65, 300, 1024, 5000):
        assert EngineConfig().with_token_chunk(n).prefill_buckets == \
            J().with_token_chunk(n).prefill_buckets


# --------------------------------------------------------------------------
# the port's own contracts (tests/test_server.py's, on fresh apps)
# --------------------------------------------------------------------------

def test_tts_determinism_over_http(both):
    outs = [http_call(both[1], "POST", "/api/tts",
                      {"text": "abc", "seed": 7})[2] for _ in range(2)]
    assert json.loads(outs[0])["audio_base64"] == \
        json.loads(outs[1])["audio_base64"]


def test_concurrent_requests_batched(jax_weights, tmp_path):
    with port_server(jax_weights, tmp_path,
                     tts_engine="static") as port:
        box = [None] * 4

        def go(i):
            box[i] = http_call(port, "POST", "/api/tts",
                               {"text": f"req {i}", "seed": i})

        threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        for status, _, body in box:
            assert status == 200 and json.loads(body)["success"]
        m = http_call(port, "GET", "/metrics")[2].decode()
        assert "rwkv_tts_batcher_batches" in m
        assert "rwkv_tts_tts_requests 4" in m
        assert "rwkv_tts_batcher_batched_requests 4" in m


def test_stream_and_batch_concurrently(both):
    """A stream and a non-streaming request at once, on the same engine:
    both complete."""
    box = {}

    def stream():
        box["stream"] = http_stream(both[1], {"text": "concurrent stream",
                                              "seed": 1})

    t = threading.Thread(target=stream)
    t.start()
    status, _, body = http_call(both[1], "POST", "/api/tts",
                                {"text": "concurrent batch", "seed": 2})
    t.join(timeout=300)
    assert not t.is_alive()
    assert status == 200 and json.loads(body)["success"]
    assert box["stream"][1] and box["stream"][1][-1]["final"]


def test_tts_engine_modes_audio_identical(jax_weights, tmp_path):
    """/api/tts through the continuous slot engine and through the static
    DynamicBatcher path give byte-identical audio for the same seeded
    request: the engines are token-identical and vocode is shared."""
    audio = []
    for mode in ("continuous", "static"):
        (tmp_path / mode).mkdir()
        with port_server(jax_weights, tmp_path / mode,
                         tts_engine=mode) as port:
            status, _, body = http_call(port, "POST", "/api/tts",
                                        {"text": "engine unification",
                                         "seed": 11})
            j = json.loads(body)
            assert status == 200 and j["success"], j
            assert set(j["timings_ms"]) >= {"generate", "detokenize"}
            audio.append(j["audio_base64"])
    assert audio[0] == audio[1]
    with pytest.raises(ValueError, match="tts_engine"):
        P.create_app(port_pipeline(jax_weights, tmp_path), BatchConfig(),
                     tts_engine="bogus")


def test_build_pipeline_honors_flags(tmp_path, monkeypatch):
    monkeypatch.setenv("RWKV_TTS_PLATFORM", "cpu")
    # the start-up download check, stubbed: nothing leaves the machine
    calls = []
    monkeypatch.setattr("rwkv_tts_tpu_torch.utils.download.ensure_models",
                        lambda model_dir, **kw: calls.append(model_dir) or [])

    def ns(**kw):
        return P.parse_args(["--model-path",
                             str(tmp_path / "absent.safetensors"),
                             "--raf-dir", str(tmp_path / "raf"),
                             "--token-chunk-size", "96"] + kw.pop("argv", []))

    pipe = P.build_pipeline_from_args(ns())
    assert calls == [str(tmp_path)]          # the download check ran
    assert pipe.engine.engine_cfg.prefill_buckets[-1] == 96
    assert pipe.device.type == "cpu" and pipe.engine.cfg.n_embd == 256
    pipe = P.build_pipeline_from_args(ns(argv=["--no-download",
                                               "--token-chunk-size", "40",
                                               "--cached-speaker"]))
    assert pipe.engine.engine_cfg.prefill_buckets == (40,)
    assert pipe.cached_speaker_default is True
    assert calls == [str(tmp_path)]          # --no-download gates it
    # a checkpoint on disk that is neither safetensors nor a prefab raises
    # and does not fall back to random weights
    ckpt = tmp_path / "webrwkv.safetensors"
    ckpt.write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="neither a safetensors file nor a "
                                         "readable web-rwkv prefab"):
        P.build_pipeline_from_args(P.parse_args(["--model-path", str(ckpt)]))
    # a real one loads, with the flags (the codecs random here, at small
    # shapes: the directory holds none)
    from rwkv_tts_tpu_torch.models import codec_loader
    from test_convert import make_rwkv7_checkpoint, write_safetensors

    write_safetensors(str(ckpt), make_rwkv7_checkpoint())
    monkeypatch.setattr(codec_loader, "BiCodecConfig", BiCodecConfig.tiny)
    monkeypatch.setattr(codec_loader, "Wav2Vec2Config",
                        lambda: Wav2Vec2Config(**W2V))
    pipe = P.build_pipeline_from_args(P.parse_args([
        "--model-path", str(ckpt), "--raf-dir", str(tmp_path / "raf"),
        "--token-chunk-size", "40", "--cached-speaker",
        "--allow-random-codec", "--quant-type", "int8"]))
    assert (pipe.engine.cfg.n_layer, pipe.engine.cfg.n_embd) == (2, 128)
    assert pipe.engine.engine_cfg.prefill_buckets == (40,)
    assert pipe.cached_speaker_default is True
    assert "q" in pipe.engine.params["head"]
    # --tp 2 over the one visible CPU device: the mesh cannot be built
    with pytest.raises(SystemExit, match="does not divide the 1 visible"):
        P.build_pipeline_from_args(ns(argv=["--tp", "2"]))


def test_ui_i18n_and_waveform_markup(both):
    body = http_call(both[1], "GET", "/")[2].decode()
    for marker in ('data-i18n', 'id="lang-toggle"', '"zh"',
                   'id="wave"', 'drawWave', '/api/tts/stream',
                   'very_high_pitch', 'middle-aged', '"CONTEMPT"',
                   '音色库', 'id="cached-speaker"', '缓存音色'):
        assert marker in body, marker
    emos = re.search(r'const EMOTIONS = \[(.*?)\]', body, re.S).group(1)
    assert emos.count('"') == 50


def test_metrics_histograms(jax_weights, tmp_path):
    with port_server(jax_weights, tmp_path) as port:
        status, _, body = http_call(port, "POST", "/api/tts",
                                    {"text": "hist", "seed": 1})
        assert json.loads(body)["success"]
        m = http_call(port, "GET", "/metrics")[2].decode()
        assert "# TYPE rwkv_tts_request_seconds histogram" in m
        assert 'rwkv_tts_request_seconds_bucket{le="+Inf"} 1' in m
        assert "rwkv_tts_rtf_count 1" in m
        assert re.search(r"^rwkv_tts_continuous_blocks [1-9]", m, re.M)


def test_stage_breakdown_histograms(jax_weights, tmp_path):
    """Queue wait, first emit and first chunk populate after a streamed
    request and render in /metrics."""
    with port_server(jax_weights, tmp_path) as port:
        status, lines, _, _ = http_stream(port, {"text": "stage timing",
                                                 "seed": 4})
        assert status == 200 and lines[-1]["final"]
        m = http_call(port, "GET", "/metrics")[2].decode()
    for h in ("rwkv_tts_stage_queue_wait_seconds",
              "rwkv_tts_stage_first_emit_seconds",
              "rwkv_tts_stage_first_chunk_seconds"):
        assert f"# TYPE {h} histogram" in m, h
        assert int(re.search(rf"^{h}_count (\d+)$", m, re.M).group(1)) >= 1
    qw = float(re.search(r"^rwkv_tts_stage_queue_wait_seconds_sum (\S+)$",
                         m, re.M).group(1))
    fe = float(re.search(r"^rwkv_tts_stage_first_emit_seconds_sum (\S+)$",
                         m, re.M).group(1))
    assert qw >= 0.0 and fe > 0.0
    assert "rwkv_tts_tts_stream_requests 1" in m


def test_streaming_low_latency_option(both):
    _, lines, _, _ = http_stream(both[1], {"text": "fast stream", "seed": 9,
                                           "low_latency": True})
    assert lines and lines[-1]["final"]
    assert len(stream_pcm(lines)) > 0


def test_healthz_degraded_on_crashed_decode_loop(jax_weights, tmp_path):
    """A dead decode loop flips /healthz to 503 and shows in /metrics,
    while /api/tts falls back to the static engine and still answers."""
    app = P.create_app(port_pipeline(jax_weights, tmp_path), BATCH)
    with serving(app) as port:
        status, _, body = http_call(port, "GET", "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        status, lines, _, _ = http_stream(port, {"text": "health probe",
                                                 "seed": 1,
                                                 "latency_mode": "ultra"})
        assert status == 200
        cont = app["runtime"]["continuous"]
        cont._crashed = RuntimeError("decode loop died")
        try:
            status, _, body = http_call(port, "GET", "/healthz")
            j = json.loads(body)
            assert status == 503 and j["status"] == "degraded"
            assert j["tts_engine"] == "continuous"
            assert "decode loop died" in j["continuous_error"]
            m = http_call(port, "GET", "/metrics")[2].decode()
            assert "rwkv_tts_continuous_crashed 1" in m
            assert "rwkv_tts_continuous_slots" in m
            status, _, body = http_call(port, "POST", "/api/tts",
                                        {"text": "degraded", "seed": 2})
            assert status == 200 and json.loads(body)["success"]
            assert app["batcher"].stats["batched_requests"] == 1
        finally:
            cont._crashed = None


def test_store_less_pipeline_voice_routes(jax_weights):
    """Without a voice store: an empty list, 404 on delete and on a
    voice_id, not 500s."""
    with serving(P.create_app(port_pipeline(jax_weights, None),
                              BATCH)) as port:
        status, _, body = http_call(port, "GET", "/api/voice-clone/list")
        assert status == 200
        assert json.loads(body) == {"success": True, "voices": []}
        status, _, body = http_call(port, "POST", "/api/voice-clone/delete",
                                    {"voice_id": "nope"})
        assert status == 404 and json.loads(body)["success"] is False
        status, _, body = http_call(port, "POST", "/api/tts",
                                    {"text": "x", "voice_id": "nope"})
        assert status == 404


def test_stream_survives_server_teardown(jax_weights, tmp_path):
    """Closing the server mid-stream ends the stream's request (its slot
    is cancelled) and leaks no thread exception; the connection's thread
    ends."""
    thread_errors = []
    orig_hook = threading.excepthook
    threading.excepthook = thread_errors.append
    try:
        app = P.create_app(port_pipeline(jax_weights, tmp_path), BATCH)
        srv = P.make_server(app, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        conn = http.client.HTTPConnection("127.0.0.1",
                                          srv.server_address[1], timeout=300)
        conn.request("POST", "/api/tts/stream",
                     body=json.dumps({"text": "abandoned mid stream",
                                      "seed": 3, "latency_mode": "flash"}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200
        json.loads(r.readline())          # one chunk, then tear down
        before = set(threading.enumerate())
        srv.shutdown()
        srv.server_close()
        app.close()
        conn.close()
        cont = app["runtime"]["continuous"]
        assert not cont._live and cont._thread is None
        assert not app["runtime"]["flights"]
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and any(
                t.is_alive() and "process_request" in t.name
                for t in before):
            time.sleep(0.05)
        assert not any(t.is_alive() and "process_request" in t.name
                       for t in before)
    finally:
        threading.excepthook = orig_hook
    assert not thread_errors, [
        (e.exc_type, str(e.exc_value)) for e in thread_errors]


def test_client_gone_mid_stream_cancels_its_slot(jax_weights, tmp_path):
    """A client that closes its connection mid-stream frees its slot: a
    later write fails and the handler cancels the request (a long stream:
    up to 400 tokens in flash mode's 8-token chunks)."""
    app = P.create_app(port_pipeline(jax_weights, tmp_path,
                                     max_semantic_tokens=400), BATCH,
                       stream_block=4)
    with serving(app) as port:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/api/tts/stream",
                     body=json.dumps({"text": "gone", "seed": 5,
                                      "latency_mode": "flash"}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        json.loads(r.readline())
        conn.sock.close()
        conn.close()
        cont = app["runtime"]["continuous"]
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and (cont._live or
                                               app["runtime"]["flights"]):
            time.sleep(0.05)
        assert not cont._live and not app["runtime"]["flights"]
        assert "rwkv_tts_tts_stream_requests" not in \
            http_call(port, "GET", "/metrics")[2].decode()


def test_stream_block_flag(jax_weights, tmp_path):
    """--stream-block reaches the continuous engine's block size; a block-8
    stream still produces complete audio."""
    app = P.create_app(port_pipeline(jax_weights, tmp_path), BATCH,
                       stream_block=8)
    with serving(app) as port:
        status, lines, _, _ = http_stream(port, {"text": "block eight",
                                                 "seed": 4,
                                                 "latency_mode": "flash"})
        assert status == 200 and lines and lines[-1]["final"]
        assert app["runtime"]["continuous"].block == 8
    assert P.parse_args(["--stream-block", "8"]).stream_block == 8


def test_body_limit_trace_and_chunked_upload(both, tmp_path, monkeypatch):
    """A body over the limit is refused with 413 (the JAX app's aiohttp
    client_max_size); a chunked request body is read; /debug/trace writes
    a Chrome trace of torch.profiler into the directory it returns."""
    monkeypatch.setattr(P, "MAX_BODY", 1024)
    status, h, body = http_call(both[1], "POST", "/api/tts",
                                b"{" + b" " * 2048 + b"}")
    assert status == 413 and h["access-control-allow-origin"] == "*"
    assert json.loads(body)["success"] is False
    monkeypatch.undo()
    conn = http.client.HTTPConnection("127.0.0.1", both[1], timeout=300)
    conn.request("POST", "/api/voice-clone/delete",
                 body=iter([b'{"voice_id": ', b'"nope"}']),
                 headers={"Content-Type": "application/json"},
                 encode_chunked=True)
    r = conn.getresponse()
    assert r.status == 404 and json.loads(r.read())["success"] is False
    conn.close()
    status, _, body = http_call(both[1], "POST", "/debug/trace",
                                {"seconds": 0.5, "dir": str(tmp_path)})
    j = json.loads(body)
    assert status == 200 and j == {"success": True,
                                   "trace_dir": str(tmp_path),
                                   "seconds": 0.5}
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert "traceEvents" in trace

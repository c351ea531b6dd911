"""Randomized HTTP soak of the port's server, the counterpart of
tests/test_http_soak.py: every public route under concurrent mixed load
against the real app wiring (the batcher, the continuous engine, the
pipeline and the voice store of one ``create_app``), at the goldens shape
on the CPU. The JAX test's two seeds draw its mix of 14 concurrent
requests: synthesis, streams (half of them closed by the client after the
first line), and enroll → clone → list → delete cycles. Afterwards
``/healthz`` answers 200, a request still succeeds, and no continuous-engine
slot is left live. Each request runs on a thread of its own, as the
server's connections do."""

import base64
import http.client
import json
import random
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.audio.io import encode_wav_16bit
from rwkv_tts_tpu_torch.config import (BatchConfig, BiCodecConfig,
                                       EngineConfig, RwkvConfig,
                                       Wav2Vec2Config)
from rwkv_tts_tpu_torch.models import bicodec, rwkv7, wav2vec2
from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline
from rwkv_tts_tpu_torch.runtime.voice_store import VoiceStore
from rwkv_tts_tpu_torch.server import app as A

http_call = chip_smoke.http_call


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_pipeline(tmpdir) -> TtsPipeline:
    """tests/test_server.py's ``tiny_pipeline`` in the port: the goldens
    LM shape, a tiny codec and a 2-layer wav2vec2, seeded."""
    lm_cfg = RwkvConfig(**chip_smoke.GOLDENS_CFG)
    bc_cfg = BiCodecConfig.tiny(feat_dim=32)
    w2v_cfg = Wav2Vec2Config(num_layers=2, hidden_size=32, num_heads=2,
                             ffn_size=64, conv_dims=(16,) * 7)
    gen = torch.Generator().manual_seed(0)
    return TtsPipeline(
        rwkv7.init_params(lm_cfg, gen, "cpu"), lm_cfg,
        bicodec.init_params(bc_cfg, gen, "cpu"), bc_cfg,
        wav2vec2.init_params(w2v_cfg, gen, "cpu"), w2v_cfg,
        voice_store=VoiceStore(str(tmpdir)),
        engine_cfg=EngineConfig(prefill_buckets=(32, 64, 128),
                                max_semantic_tokens=16, batch_size=2),
        w2v_output_layers=(1, 2), device="cpu")


def tone_wav(freq=260.0, seconds=1.5, sr=16000) -> bytes:
    t = np.arange(int(sr * seconds)) / sr
    return encode_wav_16bit(
        (0.35 * np.sin(2 * np.pi * freq * t)).astype(np.float32), sr)


def synth(port, rng, errors):
    body = {"text": f"soak {rng.randrange(1000)}", "seed": rng.randrange(99),
            "speed": rng.choice(["slow", "medium", 4.6]),
            "emotion": rng.choice(["NEUTRAL", "HAPPY", "ANGRY"])}
    return lambda: _synth(port, body, errors)


def _synth(port, body, errors):
    status, _, raw = http_call(port, "POST", "/api/tts", body, timeout=600)
    j = json.loads(raw)
    if status != 200 or not j.get("success"):
        errors.append(("tts", status, j))
    else:
        base64.b64decode(j["audio_base64"])


def stream(port, rng, errors, abort: bool):
    body = {"text": f"stream {rng.randrange(1000)}",
            "seed": rng.randrange(99),
            "latency_mode": rng.choice(["exact", "low", "ultra"])}
    return lambda: _stream(port, body, errors, abort)


def _stream(port, body, errors, abort):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/api/tts/stream", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        if r.status != 200:
            errors.append(("stream", r.status, r.read()))
            return
        for line in r:
            if not line.strip():
                continue
            msg = json.loads(line)
            if msg.get("error"):
                errors.append(("stream-line", msg))
                return
            if abort or msg.get("final"):
                return      # abort: the client walks away mid-stream
    finally:
        conn.close()


def enroll_cycle(port, rng, errors):
    name = f"soak-{rng.randrange(10 ** 6)}"
    wav = tone_wav(200 + rng.random() * 200)
    return lambda: _enroll_cycle(port, name, wav, errors)


def _enroll_cycle(port, name, wav, errors):
    body, ctype = chip_smoke.multipart_body({
        "voice_name": name, "prompt_text": "soak voice",
        "audio_file": ("a.wav", wav)})
    status, _, raw = http_call(port, "POST", "/api/voice-clone/extract",
                               body, {"Content-Type": ctype}, timeout=600)
    j = json.loads(raw)
    if status != 200 or not j.get("success"):
        errors.append(("extract", status, j))
        return
    vid = j["voice_id"]
    # clone with it, list it, delete it
    status, _, raw = http_call(port, "POST", "/api/tts",
                               {"text": "clone", "voice_id": vid},
                               timeout=600)
    if status != 200:
        errors.append(("clone", status, raw))
    voices = json.loads(http_call(port, "GET",
                                  "/api/voice-clone/list")[2])["voices"]
    if vid not in {v["id"] for v in voices}:
        errors.append(("list-missing", vid))
    status, _, raw = http_call(port, "POST", "/api/voice-clone/delete",
                               {"voice_id": vid})
    if status != 200:
        errors.append(("delete", status, raw))


@pytest.mark.parametrize("seed", [1337, 2024])
def test_http_soak_mixed_routes(tmp_path, seed):
    rng = random.Random(seed)
    app = A.create_app(tiny_pipeline(tmp_path),
                       BatchConfig(max_batch_size=4, collect_timeout_ms=5,
                                   inference_timeout_ms=120000))
    srv = A.make_server(app, "127.0.0.1", 0)
    serve = threading.Thread(target=srv.serve_forever, daemon=True)
    serve.start()
    port = srv.server_address[1]
    errors: list = []
    try:
        jobs = []
        for _ in range(14):
            kind = rng.randrange(4)
            if kind == 1:
                jobs.append(stream(port, rng, errors,
                                   abort=bool(rng.randrange(2))))
            elif kind == 2:
                jobs.append(enroll_cycle(port, rng, errors))
            else:
                jobs.append(synth(port, rng, errors))
        threads = [threading.Thread(target=job) for job in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads), "a request hung"
        assert not errors, errors

        # the server must still be fully healthy afterwards: no leaked
        # slots (aborted streams cancelled), the store consistent
        status, _, raw = http_call(port, "GET", "/healthz")
        assert status == 200, raw
        status, _, raw = http_call(port, "POST", "/api/tts",
                                   {"text": "after soak", "seed": 7})
        assert status == 200 and json.loads(raw)["success"]
        cont = app["runtime"]["continuous"]
        assert cont is not None
        done = threading.Event()
        for _ in range(100):        # retire any in-flight work
            if not cont._live:
                break
            done.wait(0.1)
        assert not cont._live, "leaked continuous-engine slots"
        listed = json.loads(http_call(port, "GET",
                                      "/api/voice-clone/list")[2])["voices"]
        assert not [v for v in listed if v.get("name", "").startswith(
            "soak-")], "a deleted voice is still listed"
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()
        serve.join(timeout=30)

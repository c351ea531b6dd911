"""Tensor parallelism through the port's serving stack on virtual CPU meshes:
``TtsEngine(tp_mesh=)`` for property and zero-shot batches of 4, 1 and 3
(padded to the data axis and trimmed) and enrollment under dp = 4, each
with the unsharded engine's tokens exactly; the engine's five refusals in
the JAX engine's order and words; the parity engine's guard; the
continuous engine's mesh checks; ``TtsPipeline.from_checkpoints(tp_mesh=)``
serving int8 for a 4-bit request and the raw layout for ``fuse``; the
pipeline's warmup on the staged TP path; and the server's ``--tp`` wiring:
``--tp 2`` over 4 visible CPU devices answers ``/api/tts`` and
``/api/tts/stream`` with the WAV of ``--tp 1``, and a ``--tp`` that does not
divide the devices exits."""

import json
import logging
import threading

import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import (BatchConfig, BiCodecConfig,
                                       EngineConfig, TtsArgs, Wav2Vec2Config)
from rwkv_tts_tpu_torch.models import bicodec, rwkv7, wav2vec2
from rwkv_tts_tpu_torch.ops.quant import quantize_rwkv_params
from rwkv_tts_tpu_torch.parallel import mesh as meshlib
from rwkv_tts_tpu_torch.runtime import continuous as CT
from rwkv_tts_tpu_torch.runtime.continuous import ContinuousEngine
from rwkv_tts_tpu_torch.runtime.engine import TtsEngine
from rwkv_tts_tpu_torch.runtime.parity import ReferenceRngEngine
from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline
from rwkv_tts_tpu_torch.server import app as A
from rwkv_tts_tpu_torch.utils import bridge
from test_torch_tp import CFG_V, CFG_V_KW, cpu_mesh, seeded_params

ECFG = EngineConfig(prefill_buckets=(32, 64), max_semantic_tokens=16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return bridge.rwkv7_params(seeded_params(CFG_V_KW), device="cpu")


@pytest.fixture(scope="module")
def engines(params):
    base = TtsEngine(params, CFG_V, ECFG, device="cpu")
    return base, TtsEngine(params, CFG_V, ECFG, tp_mesh=cpu_mesh(2))


REQS = [
    TtsArgs(text="tensor parallel serving", seed=5, max_tokens=16),
    TtsArgs(text="two", seed=6, max_tokens=16, gender="male"),
    TtsArgs(text="three voices", seed=7, max_tokens=16),
    TtsArgs(text="four", seed=8, max_tokens=16, pitch="high_pitch"),
]
ZS = [TtsArgs(text="cloned speech", seed=9, max_tokens=16, zero_shot=True,
              ref_global_tokens=list(range(32)))] * 4


@pytest.mark.parametrize("batch", [REQS, ZS, REQS[:1], REQS[:3]],
                         ids=["property", "zero_shot", "one", "three"])
def test_tts_engine_tp_mesh_token_identical(engines, batch):
    """The serving-level wiring: an uneven batch pads to the data axis (4)
    and is trimmed; the tokens are the plain engine's."""
    base, tpe = engines
    want = base.generate_batch(batch)
    got = tpe.generate_batch(batch)
    assert len(got) == len(batch)
    for w, g in zip(want, got):
        assert w.global_tokens == g.global_tokens
        assert w.semantic_tokens == g.semantic_tokens
        assert (w.prefill_tokens, w.decode_steps) == \
            (g.prefill_tokens, g.decode_steps)


def test_tp_speaker_enrollment_token_identical(engines):
    """``generate_speaker_tokens`` under dp = 4 repeats the B = 1 prompt to
    the data axis and keeps row 0."""
    base, tpe = engines
    assert tpe.tp_mesh.dp == 4
    args = TtsArgs(text="", gender="male", pitch="high_pitch")
    want = base.generate_speaker_tokens(args, seed=3)
    assert len(want) == 32
    assert tpe.generate_speaker_tokens(args, seed=3) == want


# each refusal: (the tree, the mesh, the JAX engine's words)
REFUSALS = {
    "model axis 1": (lambda p: p, lambda: cpu_mesh(1),
                     "needs a model axis > 1"),
    "heads": (lambda p: p, lambda: cpu_mesh(8),      # CFG_V has 4 heads
              "must divide the model's head count"),
    "quant layers": (lambda p: quantize_rwkv_params(p, quant_layers=1),
                     lambda: cpu_mesh(2), "partial --quant-layers"),
    "zrkv": (lambda p: rwkv7.fuse_params(p, CFG_V), lambda: cpu_mesh(2),
             "takes the RAW layout"),
    "int4": (lambda p: quantize_rwkv_params(p, kind="int4"),
             lambda: cpu_mesh(2),
             "int4/NF4 quantized layouts are not TP-shardable"),
    "nf4": (lambda p: quantize_rwkv_params(p, kind="nf4"),
            lambda: cpu_mesh(2),
            "int4/NF4 quantized layouts are not TP-shardable"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_tp_engine_refusals(params, case):
    tree, mesh, msg = REFUSALS[case]
    with pytest.raises(ValueError, match=msg):
        TtsEngine(tree(params), CFG_V, ECFG, tp_mesh=mesh())


def test_parity_engine_refuses_a_mesh(engines):
    with pytest.raises(ValueError, match="single-chip batch-1 path"):
        ReferenceRngEngine(engines[1])
    ReferenceRngEngine(engines[0])


def test_continuous_engine_mesh_checks(params):
    m = cpu_mesh(2)
    with pytest.raises(ValueError, match="occupancy buckets cannot combine"):
        ContinuousEngine(params, CFG_V, ECFG, slots=8, buckets=(4,), mesh=m)
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        ContinuousEngine(params, CFG_V, ECFG, slots=6, mesh=m)
    with pytest.raises(ValueError, match="not the mesh's"):
        ContinuousEngine(params, CFG_V, ECFG, slots=8, mesh=m,
                         device="cuda")
    eng = ContinuousEngine(params, CFG_V, ECFG, slots=8, mesh=m)
    assert eng.buckets == () and eng.inner.tp_mesh is m
    assert [len(s["stage"]) for s in eng.slots] == [2] * 4


def test_continuous_mesh_rows_admit_and_cancel(params, engines):
    """On a dp 2 × tp 2 mesh one burst lands across both data rows (each
    row's share scattered into it), a request cancelled after admission is
    idled in its own row, and the others emit the static engine's tokens;
    the engine without a mesh is one row."""
    eng = ContinuousEngine(params, CFG_V, ECFG, slots=4, block=4,
                           mesh=cpu_mesh(2, n=4))
    assert eng._by_row([3, 0, 2]) == {1: ([0, 2], [1, 0]), 0: ([1], [0])}
    plain = ContinuousEngine(params, CFG_V, ECFG, slots=4, device="cpu")
    assert plain._by_row([3, 0]) == {0: ([0, 1], [3, 0])}
    victim = TtsArgs(text="cancelled after admission", seed=12,
                     max_tokens=16)
    burst = [REQS[0], REQS[1], victim, REQS[2]]
    box, done = {}, threading.Event()

    def result(args):
        def cb(res):
            box[id(args)] = res
            if len(box) == len(burst):
                done.set()
        return cb

    def cancel_on_first_chunk(args, _tokens):
        eng.cancel(args)

    try:
        eng.submit_burst([(a, result(a), cancel_on_first_chunk
                           if a is victim else None) for a in burst])
        assert done.wait(300.0)
    finally:
        eng.stop()
    assert isinstance(box[id(victim)], CT.RequestCancelled)
    base = engines[0]
    for a in (REQS[0], REQS[1], REQS[2]):
        want, got = base.generate(a), box[id(a)]
        assert (got.global_tokens, got.semantic_tokens) == \
            (want.global_tokens, want.semantic_tokens), a.text
    assert not eng._live and eng.stats["admitted"] == 4
    assert all(bool((s["stage"] == CT.IDLE).all()) for s in eng.slots)


@pytest.fixture
def loaders(monkeypatch, params):
    """``from_checkpoints`` with the LM file read replaced by the seeded
    tree and the codecs by tiny random ones."""
    from rwkv_tts_tpu_torch.models import codec_loader, convert

    gen = torch.Generator().manual_seed(0)
    bc_cfg = BiCodecConfig.tiny(feat_dim=32)
    w2v_cfg = Wav2Vec2Config(num_layers=2, hidden_size=32, num_heads=2,
                             ffn_size=64, conv_dims=(16,) * 7)
    codecs = (bicodec.init_params(bc_cfg, gen, "cpu"), bc_cfg,
              wav2vec2.init_params(w2v_cfg, gen, "cpu"), w2v_cfg, (1, 2))
    monkeypatch.setattr(convert, "load_rwkv7",
                        lambda path, dtype, device: (params, CFG_V))
    monkeypatch.setattr(codec_loader, "load_codecs",
                        lambda d, allow_random, device: codecs)


@pytest.mark.parametrize("quant", ["int4", "nf4", "sf4", "int8"])
def test_from_checkpoints_tp_mesh_serves_the_raw_int8_layout(
        loaders, tmp_path, caplog, quant):
    ckpt = tmp_path / "webrwkv.safetensors"
    ckpt.write_bytes(b"")
    with caplog.at_level(logging.WARNING):
        pipe = TtsPipeline.from_checkpoints(
            str(ckpt), raf_dir=str(tmp_path), quant_type=quant, fuse=True,
            device="cpu", engine_cfg=ECFG, tp_mesh=cpu_mesh(2))
    assert (f"{quant} layout is not TP-shardable — serving int8 instead"
            in caplog.text) == (quant != "int8")
    blocks = pipe.engine.params["blocks"]
    assert "zrkv" not in blocks and set(blocks["w_r"]) == {"q", "s"}
    assert pipe.engine.tp_mesh.mp == 2
    out = pipe.synthesize(TtsArgs(text="loaded", seed=1, max_tokens=4))
    assert len(out.audio) == 320 * len(out.semantic_tokens)


def test_pipeline_warmup_runs_the_staged_tp_path(loaders, tmp_path):
    ckpt = tmp_path / "webrwkv.safetensors"
    ckpt.write_bytes(b"")
    pipe = TtsPipeline.from_checkpoints(
        str(ckpt), raf_dir=str(tmp_path), device="cpu", engine_cfg=ECFG,
        tp_mesh=cpu_mesh(2))
    out = pipe.warmup(detok_buckets=(64,), zero_shot_too=True)
    assert {"lm_normal_32_b4", "lm_zs_64_b4", "prefill_64", "global_stage",
            "semantic_normal", "semantic_zs", "detokenize_64"} <= set(out)
    assert "skipped" not in out


def serve_once(monkeypatch, tmp_path, tp: int):
    """A dev-mode server started by ``build_pipeline_from_args`` with
    ``--tp``: one /api/tts and one /api/tts/stream; returns (WAV base64,
    stream lines, the continuous engine's mesh). Random weights seldom
    draw EOS, so the engine config caps a request at 12 tokens."""
    monkeypatch.setattr(A, "EngineConfig",
                        lambda: EngineConfig(max_semantic_tokens=12))
    pipe = A.build_pipeline_from_args(A.parse_args([
        "--model-path", str(tmp_path / "absent.safetensors"),
        "--raf-dir", str(tmp_path / "raf"), "--tp", str(tp),
        "--no-download"]))
    app = A.create_app(pipe, BatchConfig(max_batch_size=4,
                                         collect_timeout_ms=5))
    srv = A.make_server(app, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        body = {"text": "tensor parallel", "seed": 3}
        status, _, raw = chip_smoke.http_call(port, "POST", "/api/tts",
                                              body)
        assert status == 200, raw
        sstatus, lines, _, _ = chip_smoke.http_stream(
            port, dict(body, latency_mode="flash"))
        assert sstatus == 200 and lines and lines[-1]["final"]
        cont = app["runtime"]["continuous"]
        mesh = cont.mesh
        assert not cont._live, "leaked continuous-engine slots"
        return json.loads(raw)["audio_base64"], lines, mesh
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()
        t.join(timeout=30)


def cpu_devices(monkeypatch, n: int):
    """The server's mesh over ``n`` visible CPU devices: a virtual mesh,
    as the JAX tests' forced host device count gives theirs."""
    monkeypatch.setenv("RWKV_TTS_PLATFORM", "cpu")
    monkeypatch.setattr(meshlib, "visible_devices",
                        lambda platform: [torch.device(platform)] * n)


def test_server_tp2_on_a_virtual_cpu_mesh(monkeypatch, tmp_path):
    cpu_devices(monkeypatch, 4)
    wav2, lines2, mesh = serve_once(monkeypatch, tmp_path, 2)
    assert mesh.shape == {"data": 2, "model": 2}
    wav1, lines1, none = serve_once(monkeypatch, tmp_path, 1)
    assert none is None
    # the same tokens through the sharded engines: the same audio
    assert wav2 == wav1
    assert [ln["audio_base64"] for ln in lines2] == \
        [ln["audio_base64"] for ln in lines1]


@pytest.mark.parametrize("devices,tp", [(3, 2), (4, 3), (1, 2)])
def test_tp_that_does_not_divide_the_devices_exits(monkeypatch, tmp_path,
                                                   devices, tp):
    cpu_devices(monkeypatch, devices)
    with pytest.raises(SystemExit, match=f"--tp {tp} does not divide the "
                                         f"{devices} visible devices"):
        A.build_pipeline_from_args(A.parse_args([
            "--model-path", str(tmp_path / "absent.safetensors"),
            "--raf-dir", str(tmp_path), "--tp", str(tp), "--no-download"]))

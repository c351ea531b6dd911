"""The port's LM tools (``rwkv_tts_tpu_torch/tools``: ``profile_first_chunk``,
``profile_int4_b8``, ``profile_fused_ab``, ``bench_continuous``) against
the JAX package's tools of the same names (``tools/*.py``), on the CPU at
toy depth through ``main(argv, device="cpu")``: each prints the JAX tool's
lines or JSON keys, named here and found in the JAX tool's source, with
values that agree with the configuration (EOS forbidden: every stage runs
the steps asked for; the tokens total is the sum of the requests' tokens;
the audio is the tokens at 50 a second). ``chip_smoke.py``'s ``lm_tools``
phase runs here at toy depth.
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch import constants as C
from rwkv_tts_tpu_torch.tools import (bench_continuous, profile_first_chunk,
                                      profile_fused_ab, profile_int4_b8)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"profile_first_chunk": profile_first_chunk,
         "profile_int4_b8": profile_int4_b8,
         "profile_fused_ab": profile_fused_ab,
         "bench_continuous": bench_continuous}
TOY = ["--layers", "2", "--embd", "128"]
TINY = TOY + ["--tiny-codec"]
# each tool at toy depth on the CPU
TOY_ARGV = {
    "profile_first_chunk": ["8", "5", "--iters", "1"] + TINY,
    "profile_int4_b8": ["--steps", "5", "--iters", "1"] + TINY,
    "profile_fused_ab": ["8", "5", "--iters", "1"] + TOY,
    "bench_continuous": ["6", "8", "4", "--caps", "3,6,9", "--pad", "12"]
    + TINY}
# the JAX tools' printed lines and JSON keys
FIRST_CHUNK_LINES = ("fused LM program:", "dispatch glue", "prefill(",
                     "global (32)   :", "semantic(", "+TAG_1):",
                     "vocode window :", "TOTAL         :", "ms/step")
INT4_LAYOUT_KEYS = ("wall_s_lm", "wall_s_detok", "step_ms",
                    "rtf_e2e_batch8", "xrt_e2e_batch8")
INT4_KEYS = ("backend", "batch", "steps", "int8", "int4", "int4_wins")
FUSED_AB_KEYS = ("batch", "steps", "fused_ms_step", "raw_ms_step",
                 "raw_speedup")
CONTINUOUS_KEYS = ("backend", "requests", "slots", "block", "token_caps",
                   "tokens_total", "audio_sec", "wall_s_llm", "wall_s_detok",
                   "xrt_continuous_llm", "xrt_continuous_e2e", "loop_stats")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_source(name: str) -> str:
    with open(os.path.join(ROOT, "tools", f"{name}.py")) as f:
        return f.read()


def last_json(text: str):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_refuses_the_cpu_unless_asked(name):
    """Without ``device`` a tool asks for the card, and there is none
    here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TOOLS[name].main(TOY_ARGV[name])


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_runs_as_a_module(name):
    r = subprocess.run([sys.executable, "-m",
                        f"rwkv_tts_tpu_torch.tools.{name}", "--help"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(f"usage: {name}")


def test_the_jax_tools_have_these_keys():
    """The lines and keys the tests hold the port's tools to are the JAX
    tools' own."""
    src = jax_source("profile_first_chunk")
    for frag in FIRST_CHUNK_LINES:
        assert frag in src, frag
    src = jax_source("profile_int4_b8")
    for k in INT4_LAYOUT_KEYS + INT4_KEYS:
        assert f'"{k}"' in src, k
    src = jax_source("profile_fused_ab")
    for k in FUSED_AB_KEYS:
        assert f'"{k}"' in src, k
    src = jax_source("bench_continuous")
    for k in CONTINUOUS_KEYS:
        assert f'"{k}"' in src, k
    for n in ("128, 256, 384, 512", "1000 + i", "6 + (i % 11)"):
        assert n in src, n


def test_profile_first_chunk_prints_the_jax_lines(capsys):
    """The JAX tool's lines, then the JSON line: each stage's wall ms (no
    device reading on the CPU), the LM program against the stages' sum
    and the glue between them; EOS is forbidden, so the program ran every
    step."""
    out = profile_first_chunk.main(TOY_ARGV["profile_first_chunk"],
                                   device="cpu")
    text = capsys.readouterr().out
    for frag in FIRST_CHUNK_LINES:
        assert frag in text, frag
    assert "bench first_chunk was" not in text
    assert re.search(r"^semantic\(5\+TAG_1\):", text, re.MULTILINE)
    assert last_json(text) == json.loads(json.dumps(out))
    st = out["stages"]
    assert set(st) == {"prefill", "global", "semantic", "vocode",
                       "lm_program"}
    for k, v in st.items():
        assert v["wall_ms"] > 0 and v["first_s"] > 0
        if k != "lm_program":
            assert v["busy_ms"] is None and v["kernels"] is None
    staged = sum(st[k]["wall_ms"] for k in ("prefill", "global", "semantic"))
    assert out["staged_lm_ms"] == pytest.approx(staged)
    assert out["fused_lm_ms"] == st["lm_program"]["wall_ms"]
    assert out["glue_ms"] == pytest.approx(staged - out["fused_lm_ms"])
    assert (out["batch"], out["sem_steps"], out["prefill"], out["window"]) \
        == (8, 5, 64, 80)
    assert (out["quant"], out["state_dtype"]) == ("int8", "bfloat16")


def test_profile_int4_b8_prints_the_jax_keys(capsys):
    """Both layouts' JAX keys; ``step_ms`` is the LM wall over 32 + steps
    steps, the RTF the walls over the audio of 8 × steps tokens and its
    inverse the xRT; ``meets_rtf_limit`` (RTF < 0.3) takes the JAX tool's
    0.025 line's place."""
    out = profile_int4_b8.main(TOY_ARGV["profile_int4_b8"], device="cpu")
    text = capsys.readouterr().out
    assert last_json(text) == json.loads(json.dumps(out))
    for k in INT4_KEYS:
        assert k in out, k
    assert "meets_002_line" not in out
    assert (out["backend"], out["batch"], out["steps"]) == ("cpu", 8, 5)
    audio = 8 * 5 / C.TOKENS_PER_SECOND
    for q in ("int8", "int4"):
        r = out[q]
        for k in INT4_LAYOUT_KEYS:
            assert r[k] > 0, (q, k)
        assert r["step_ms"] == pytest.approx(r["wall_s_lm"] / (32 + 5) * 1e3)
        wall = r["wall_s_lm"] + r["wall_s_detok"]
        assert r["rtf_e2e_batch8"] == pytest.approx(wall / audio)
        assert r["xrt_e2e_batch8"] == pytest.approx(audio / wall)
        assert r["detok"] == "eager" and r["step_busy_ms"] is None
    i8, i4 = out["int8"]["rtf_e2e_batch8"], out["int4"]["rtf_e2e_batch8"]
    assert out["int4_wins"] == (i4 < i8)
    assert out["meets_rtf_limit"] == (min(i4, i8) < 0.3)


def test_profile_fused_ab_prints_the_jax_keys(capsys):
    """Each layout's line (weights GB, ms a stage and a step, tok/s), then
    the JAX keys; the fused tree is the larger (zrkv doubles r/k/v), the
    speedup is fused over raw, and each stage ran TAG_1 and every step."""
    out = profile_fused_ab.main(TOY_ARGV["profile_fused_ab"], device="cpu")
    text = capsys.readouterr().out
    lines = [l for l in text.splitlines() if l.startswith("[")]
    assert [l.split("]")[0] for l in lines] == ["[fused+int8", "[raw+int8"]
    for l in lines:
        assert re.search(r"weights [\d.]+ GB .* ms/stage .* ms/step .* tok/s",
                         l), l
    assert last_json(text) == json.loads(json.dumps(out))
    for k in FUSED_AB_KEYS:
        assert k in out, k
    assert (out["batch"], out["steps"]) == (8, 5)
    assert out["raw_speedup"] == pytest.approx(out["fused_ms_step"]
                                               / out["raw_ms_step"])
    assert out["fused"]["weights_gb"] > out["raw"]["weights_gb"]
    for lay in ("fused", "raw"):
        assert out[lay]["stage_steps"] == 5 + 1
        assert out[lay]["ms_step"] == pytest.approx(out[lay]["ms_stage"] / 5)


def test_bench_continuous_prints_the_jax_keys(capsys, monkeypatch):
    """The JAX keys; the JAX tool's warm-up (bursts up to min(n, slots) at
    the engine's default prefill buckets); every request served within its
    cap, the tokens total their sum and the audio that at 50 tokens a
    second; the timed-region loop stats count the admissions."""
    from rwkv_tts_tpu_torch.runtime.continuous import ContinuousEngine

    warmups, real = [], ContinuousEngine.warmup

    def spy(self, *a, **kw):
        warmups.append((a, kw))
        return real(self, *a, **kw)

    monkeypatch.setattr(ContinuousEngine, "warmup", spy)
    out = bench_continuous.main(TOY_ARGV["bench_continuous"], device="cpu")
    assert warmups == [((), {"max_burst": 6})]
    assert out["warm_burst"] == 6
    text = capsys.readouterr().out
    assert last_json(text) == json.loads(json.dumps(out))
    for k in CONTINUOUS_KEYS:
        assert k in out, k
    assert (out["backend"], out["requests"], out["slots"], out["block"]) \
        == ("cpu", 6, 8, 4)
    assert out["token_caps"] == [3, 6, 9]
    toks = out["tokens_by_request"]
    assert len(toks) == 6
    assert all(0 <= n <= out["token_caps"][i % 3] for i, n in enumerate(toks))
    assert out["tokens_total"] == sum(toks) > 0
    assert out["audio_sec"] == pytest.approx(sum(toks) / C.TOKENS_PER_SECOND)
    assert out["xrt_continuous_llm"] == pytest.approx(
        out["audio_sec"] / out["wall_s_llm"])
    assert out["xrt_continuous_e2e"] == pytest.approx(
        out["audio_sec"] / (out["wall_s_llm"] + out["wall_s_detok"]))
    assert out["loop_stats"]["admitted"] == 6
    assert out["loop_stats"]["blocks"] > 0
    assert "graph_pool_mib" not in out          # no graphs on the CPU


def test_bench_continuous_traffic_is_the_jax_tools():
    """64 requests by default: 6–16 words of the JAX tool's sentence,
    seeds 1000 + i, the caps round-robin."""
    reqs = bench_continuous.requests(64, [128, 256, 384, 512])
    src = jax_source("bench_continuous")
    for w in ("the quick brown fox", "moonlit field without a pause"):
        assert w in src
    assert [len(r.text.split()) for r in reqs[:12]] == \
        [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 6]
    assert [r.seed for r in reqs] == list(range(1000, 1064))
    assert [r.max_tokens for r in reqs[:5]] == [128, 256, 384, 512, 128]
    a = bench_continuous._args([])
    assert (a.n_requests, a.slots, a.block, a.caps, a.pad, a.warm_burst) \
        == (64, 128, 32, "128,256,384,512", 512, None)


def test_lm_tools_phase_on_the_cpu():
    """``chip_smoke.py``'s ``lm_tools`` phase at toy depth: the one-call
    program against the staged chain (8 of 8, both modes), then the four
    tools, their lines and the summary entry under its budget."""
    lt = chip_smoke.lm_tools(torch, "cpu", TOY_ARGV, widths=(2, 128))
    assert lt["check"]["same"] == {"normal": 8, "zs": 8}
    for mode in ("normal", "zs"):
        assert lt["check"]["launches"][mode]["chunks"] == 1
    assert not any(lt["launches"].values())       # the CPU launches none
    lines = list(chip_smoke.lm_tools_lines(lt, "cpu"))
    assert len(lines) == 6 and all(l.startswith("lm_tools: ") for l in lines)
    entry = chip_smoke._compact(chip_smoke.lm_tools_summary(lt))
    # with the seconds and about 150 bytes of launches on a card
    assert len(json.dumps(entry, separators=(",", ":"))) < 200


def test_lm_tools_phase_depths():
    """The phase's cuts, as ``PERF.md`` §4 lists them."""
    a = chip_smoke.LM_TOOLS_ARGV
    fc = profile_first_chunk._args(a["profile_first_chunk"])
    assert (fc.batch, fc.sem_steps, fc.iters, fc.layers, fc.embd) == \
        (8, 48, 2, 32, 2048)
    i4 = profile_int4_b8._args(a["profile_int4_b8"])
    assert (i4.steps, i4.iters) == (64, 1)
    ab = profile_fused_ab._args(a["profile_fused_ab"])
    assert (ab.batch, ab.steps, ab.iters) == (128, 16, 1)
    bc = bench_continuous._args(a["bench_continuous"])
    assert (bc.n_requests, bc.slots, bc.block, bc.caps, bc.pad,
            bc.warm_burst) == (64, 128, 32, "32,64,96,128", 128, 1)
    assert chip_smoke.PHASES.index("lm_tools") == \
        chip_smoke.PHASES.index("tools") + 1


def test_run_tail_fits_with_the_lm_tools_path():
    """The kernels line with the ``lm_tools`` path beside every earlier
    path (a launch count of seven digits for every entry on each), the
    summary line at its budget and the ok line stay inside 14 KB, well
    within the 24 KB of output a run's record keeps."""
    x = 0.040559900000000065
    stats = {name: {"max_abs_err": x, "ms": x, "plain_ms": x, "bound_ms": x,
                    "bound_by": "bytes", "library_ms": x}
             for name in chip_smoke.KERNEL_ENTRIES}
    paths = {p: {k: 1234567 for k in chip_smoke.KERNEL_ENTRIES}
             for p in ("tools", "lm_tools", "parity", "tp", "main_path",
                       "cloning", "quantized", "streaming", "server", "soak",
                       "checkpoint", "checkpoint_published")}
    kernels = json.dumps({"kernels": chip_smoke.kernel_entries(stats,
                                                               paths)})
    ok = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}})
    assert chip_smoke.SUMMARY_BYTES + len(kernels) + len(ok) + 3 \
        < 14 * 1024

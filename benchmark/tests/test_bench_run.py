"""A run end to end: the last line's keys from the harness's internals on
a tiny configuration on the CPU, the refusals (no card, a bare checkout),
and the check that no JAX module is loaded. The card test runs the
command itself."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import session  # noqa: E402

TINY_RUN = textwrap.dedent("""
    import json, sys, time
    sys.path[:0] = [sys.argv[1]]
    import torch
    torch.set_num_threads(2)
    import tiny
    from harness import session
    out = session.run(tiny.tiny_cell(sys.argv[2]), 2**33 + 11, 2.5, False,
                      "cpu", time.time())
    print(json.dumps(session.forbidden_modules()))
    print(json.dumps(out))
""")


@pytest.mark.parametrize("workload", ["int8.backlog", "bf16.stream"])
def test_last_line_on_a_tiny_cell(workload):
    p = subprocess.run([sys.executable, "-c", TINY_RUN,
                        str(BENCH / "tests"), workload],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    lines = p.stdout.strip().splitlines()
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(lines[-2]) == []
    out = json.loads(lines[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = {"int8.backlog": {"audio_xrt", "setup_s"},
            "bf16.stream": {"first_chunk_p95_ms", "setup_s"}}[workload]
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["checks"]) == {"token_gap", "wave_rms"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "int8.backlog",
         "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=cwd,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_the_command_fails_without_a_card():
    p = _command(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_the_command_fails_in_a_bare_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    for name in ("rwkv_tts_tpu_torch_extra", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, object())
    assert session.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rwkv_tts_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert session.forbidden_modules() == ["jaxlib", "rwkv_tts_tpu.models"]


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["int8.backlog", "bf16.stream"])
def test_a_short_run_on_the_card(cuda_card, workload):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2**32 + 9), "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True


def test_quiet_stops_and_resumes_the_system():
    """The traced run starts and stops the profiler inside
    ``System.quiet``: no decode loop and no vocoder call run there, and
    the traffic goes on after it."""
    import time

    import torch

    sys.path.insert(0, str(BENCH / "tests"))
    import tiny
    from harness import traffic, weights
    from harness.system import System

    torch.set_num_threads(2)
    cell = tiny.tiny_cell("int8.backlog")
    cfg, mix = cell.config, cell.mix
    system = System(cfg, mix, weights.lm_tree(cfg["lm"], 3, "cpu"),
                    weights.codec_tree(cfg["codec"], 3, "cpu"), "cpu")
    reqs = traffic.requests(mix, 3, 64)
    loop = traffic.ClosedLoop(mix, reqs, traffic.first_shares(mix, 3, 4),
                              system.serve_backlog)
    loop.start()
    try:
        time.sleep(2.0)
        with system.quiet():
            assert system.engine._thread is None   # joined
            assert system._vocoding == 0
            n = len(loop.records)
            time.sleep(0.5)
            assert len(loop.records) == n
        time.sleep(2.0)
        assert len(loop.records) > n
    finally:
        loop.stop(system.cancel_all)
        system.close()

"""The port's serving tools (``rwkv_tts_tpu_torch/tools``: ``soak_serving``,
``probe_stream_latency``, ``profile_buckets``, ``profile_decode``) against
the JAX package's tools of the same names (``tools/*.py``), on the CPU at
toy sizes through ``main(argv, device="cpu")``: each prints the JAX tool's
keys and lines, the soak drives the JAX tool's traffic (its constants
read from the JAX tool itself) to ``soak_ok``, and ``chip_smoke.py``'s
``soak`` phase runs here in the soak tool's light configuration.
"""

import ast
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.tools import (probe_stream_latency, profile_buckets,
                                      profile_decode, soak_serving)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"soak_serving": soak_serving,
         "probe_stream_latency": probe_stream_latency,
         "profile_buckets": profile_buckets,
         "profile_decode": profile_decode}
TOY = ["--layers", "2", "--embd", "128"]


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


def dict_keys(src: str, opener: str):
    """The string keys of the dict literal that starts at ``opener``."""
    i = src.index(opener) + len(opener) - 1
    depth, j = 0, i
    while True:
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            break
        j += 1
    return re.findall(r'^\s*"(\w+)":', src[i:j], re.MULTILINE)


@pytest.fixture(scope="module")
def jax_soak():
    """The JAX soak tool imported as a module (its import sets two JAX
    compile-cache options, put back afterwards)."""
    jax = pytest.importorskip("jax")
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_tools_soak_serving",
            os.path.join(ROOT, "tools", "soak_serving.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


# --------------------------------------------------------------------------
# each tool's entry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_refuses_the_cpu_unless_asked(name):
    """Without ``device`` a tool asks for the card, and there is none
    here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = {"profile_buckets": ["16", "2"] + TOY,
            "profile_decode": ["8", "2"] + TOY,
            "soak_serving": ["--light", "--minutes", "0.01"],
            "probe_stream_latency": ["--light"]}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TOOLS[name].main(argv)


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_runs_as_a_module(name):
    r = subprocess.run([sys.executable, "-m",
                        f"rwkv_tts_tpu_torch.tools.{name}", "--help"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(f"usage: {name}")


def test_profile_buckets_prints_the_jax_lines(capsys):
    """The JAX tool's line per bucket (8 and the slots), then the JSON
    line; the layout is the JAX tool's (int8, bf16 state)."""
    out = profile_buckets.main(["16", "2", "--iters", "1"] + TOY,
                               device="cpu")
    text = capsys.readouterr().out
    src = jax_source("profile_buckets")
    for frag in ("bucket ", " ms/step ", " ms/block of "):
        assert frag in src
    lines = [l for l in text.splitlines() if l.startswith("bucket")]
    assert [int(re.match(r"bucket\s+(\d+):", l).group(1)) for l in lines] \
        == [8, 16]
    for l in lines:
        assert re.fullmatch(r"bucket\s+\d+:\s+[\d.]+ ms/step \(\s*[\d.]+ "
                            r"ms/block of 2\)", l), l
    assert json.loads(text.splitlines()[-1]) == json.loads(json.dumps(out))
    assert (out["quant"], out["state_dtype"]) == ("int8", "bfloat16")
    assert set(out["buckets"]) == {"8", "16"}
    assert "state_dtype=\"bfloat16\"" in src.replace("'", '"')


def test_profile_decode_prints_the_jax_lines(capsys):
    out = profile_decode.main(["8", "2", "--iters", "1"] + TOY,
                              device="cpu")
    text = capsys.readouterr().out
    src = jax_source("profile_decode")
    for label in ("semantic_stage :", "raw step scan  :", "wkv-only scan  :",
                  "matmul-only    :", "unaccounted    :", "sampler+loop =",
                  "tok/s", "ms/step"):
        assert label in src, label
        assert label in text, label
    pieces = out["pieces"]
    for k in ("semantic_stage", "semantic_stage_kernel", "raw_step",
              "raw_step_kernel", "wkv_only", "wkv_only_kernel",
              "matmul_only"):
        assert pieces[k]["wall_ms"] > 0 and pieces[k]["device_ms"] is None
    assert json.loads(text.splitlines()[-1])["tool"] == "profile_decode"
    assert (out["quant"], out["state_dtype"]) == ("int8", "bfloat16")


def test_plain_wkv_is_restored():
    """``profile_decode.plain_wkv`` swaps the model's decode WKV for its
    plain version only while inside."""
    from rwkv_tts_tpu_torch.models import rwkv7

    real = rwkv7.wkv7_decode_
    with profile_decode.plain_wkv():
        assert rwkv7.wkv7_decode_ is profile_decode._plain_decode_
    assert rwkv7.wkv7_decode_ is real


# --------------------------------------------------------------------------
# the soak and the probe
# --------------------------------------------------------------------------

def test_soak_traffic_is_the_jax_tools(jax_soak):
    """The traffic constants are the JAX tool's: its module's ``WORDS``
    and ``EMOTIONS``, and from its source the kinds cycle, the latency
    modes, the speeds, the abort share and the RNG seed."""
    assert soak_serving.WORDS == jax_soak.WORDS
    assert soak_serving.EMOTIONS == jax_soak.EMOTIONS
    src = jax_source("soak_serving")
    kinds = ast.literal_eval(re.search(r"kinds = (\[[^\]]*\])", src).group(1))
    assert soak_serving.KINDS == kinds
    choices = [ast.literal_eval(m) for m in
               re.findall(r"rng\.choice\(\s*(\[[^\]]*\])", src)]
    assert choices == [soak_serving.MODES, soak_serving.SPEEDS]
    share = float(re.search(r"rng\.random\(\) < ([\d.]+)", src).group(1))
    assert soak_serving.ABORT_SHARE == share
    assert "random.Random(7)" in src
    assert "rng = random.Random(7)" in open(soak_serving.__file__).read()


def test_soak_light_gives_soak_ok_and_the_jax_keys(jax_soak, capsys):
    """The soak tool's ``--light`` run for a few seconds at concurrency 3
    (its first three requests are one of each kind):
    ``soak_ok``, every kind served, and the JAX tool's document keys,
    snapshot keys and table header."""
    doc = soak_serving.main(["--light", "--minutes", "0.1",
                             "--concurrency", "3", "--snapshot-every", "3",
                             "--port", "0"], device="cpu")
    text = capsys.readouterr().out
    src = jax_source("soak_serving")
    assert doc["soak_ok"], doc
    assert set(dict_keys(src, "doc = {")) <= set(doc)
    assert doc["snapshots"]
    for snap in doc["snapshots"]:
        assert set(dict_keys(src, "snap = {")) <= set(snap)
        assert snap["crashed"] == 0
    assert all(doc["kinds_ok"].values()), doc["kinds_ok"]
    assert doc["slots_after_drain"] == 0 and doc["healthz"][0] == 200
    header = re.search(r'print\("\\n(\| t \(min\).*?)"\n\s+"(.*?)"\)',
                       src, re.S)
    assert header and (header.group(1) + header.group(2)) in text
    assert json.loads([l for l in text.splitlines()
                       if l.startswith('{"soak_ok"')][0]) == \
        json.loads(json.dumps(doc))


def test_probe_prints_its_three_probes(capsys):
    out = probe_stream_latency.main(["--light", "--burst", "2",
                                     "--zero-load", "1", "--port", "0"],
                                    device="cpu")
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith('{"probe"')]
    assert [l["probe"] for l in lines] == ["zero_load_low",
                                           "zero_load_flash", "burst_2"]
    assert all(len(l["first_chunk_ms"]) == n
               for l, n in zip(lines, (1, 1, 2)))
    assert set(lines[2]) == {"probe", "first_chunk_ms", "burst_wall_s",
                             "stage_means_ms"}
    assert set(lines[2]["stage_means_ms"]) >= {"queue_wait", "first_emit",
                                               "first_chunk"}
    assert out == {l["probe"]: l for l in lines}
    src = jax_source("probe_stream_latency")
    for key in ("zero_load_", "burst_", "burst_wall_s", "stage_means_ms"):
        assert key in src


def test_soak_phase_on_the_cpu():
    """``chip_smoke.py``'s ``soak`` phase in the soak tool's light
    configuration: the soak, the probe against the same drained app, the
    readings and the summary entry (the card's checks need a card)."""
    sk = chip_smoke.soak(torch, "cpu", light=True, minutes=0.1,
                         snapshot_every=3, concurrency=3, max_tokens=8,
                         burst=2, zero_load=1, need_abort=False)
    assert sk["doc"]["soak_ok"]
    assert set(sk["probe"]) == {"zero_load_low", "zero_load_flash",
                                "burst_2"}
    lines = list(chip_smoke.soak_lines(sk, "cpu"))
    assert lines[0].startswith("soak: the soak tool on its light")
    entry = chip_smoke.soak_summary(sk)
    assert entry["ok"] and entry["reqs"] == sk["doc"]["requests_ok"]
    line = chip_smoke.summary_line({"soak": {"s": 1.0, **entry}})
    assert len(line.encode()) <= chip_smoke.SUMMARY_BYTES


@pytest.mark.parametrize("exc", [ConnectionResetError, BrokenPipeError])
def test_server_logs_a_client_disconnect_without_a_traceback(capsys, exc):
    """A connection its client dropped while the handler read the next
    request (every abandoned stream of the soak) is logged, not printed:
    the soak's server printed a traceback to stderr for each. Any other
    error is still reported."""
    from rwkv_tts_tpu_torch.server import app as server_app

    srv = server_app._Server(("127.0.0.1", 0), server_app.App())
    try:
        try:
            raise exc(104, "Connection reset by peer")
        except exc:
            srv.handle_error(None, ("127.0.0.1", 1))
        assert capsys.readouterr().err == ""
        try:
            raise ValueError("a fault of the server")
        except ValueError:
            srv.handle_error(None, ("127.0.0.1", 1))
        assert "ValueError: a fault of the server" in capsys.readouterr().err
    finally:
        srv.server_close()


def test_run_tail_fits_with_the_soak_path():
    """The kernels line with the ``soak`` path beside every earlier path
    (a launch count of seven digits for every entry on each), the summary
    line at its budget and the ok line stay inside 13 KB, well within the
    24 KB of output a run's record keeps."""
    x = 0.040559900000000065
    stats = {name: {"max_abs_err": x, "ms": x, "plain_ms": x, "bound_ms": x,
                    "bound_by": "bytes", "library_ms": x}
             for name in chip_smoke.KERNEL_ENTRIES}
    paths = {p: {k: 1234567 for k in chip_smoke.KERNEL_ENTRIES}
             for p in ("tools", "parity", "tp", "main_path", "cloning",
                       "quantized", "streaming", "server", "soak",
                       "checkpoint", "checkpoint_published")}
    kernels = json.dumps({"kernels": chip_smoke.kernel_entries(stats,
                                                               paths)})
    ok = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}})
    assert chip_smoke.SUMMARY_BYTES + len(kernels) + len(ok) + 3 \
        < 13 * 1024
    assert "soak" in chip_smoke.PHASES
    assert chip_smoke.PHASES.index("soak") == \
        chip_smoke.PHASES.index("server") + 1

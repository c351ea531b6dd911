"""``BENCHMARK.json`` keeps to its format and limits, and every piece
is found by its name: a new traffic mix or metric is taken from a new file
with no edit to an existing one."""

import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness.cell import load, load_reader  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    layers = set()
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.add(m["layer"])
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_each_piece_is_found_by_name(workload):
    cell = load(workload)
    assert cell.config["name"] == next(
        w["config"] for w in SPEC["workloads"] if w["name"] == workload)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(load_reader(m["name"]))
        if m in cell.per_layer:
            assert m["moves"] in reported


def test_new_files_are_taken_without_editing_existing_ones(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "int8.tiny", "config":
                              "rwkv7-tts-32x2048-int8", "traffic": "tiny",
                              "chips": 1, "why": "a new mix"})
    spec["per_layer"].append({"name": "blocks.tiny", "unit": "1",
                              "better": "higher", "source": "program_counter",
                              "layer": "engine (runtime/continuous)",
                              "moves": "audio_xrt", "workloads": ["int8.tiny"]})
    spec["end_to_end"][0]["workloads"].append("int8.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    mix = json.loads((BENCH / "traffic" / "backlog128.json").read_text())
    mix["clients"] = 2
    (tmp_path / "benchmark" / "traffic" / "tiny.json").write_text(
        json.dumps(mix))
    (tmp_path / "benchmark" / "metrics" / "blocks.tiny.py").write_text(
        "def read(run):\n    return run.blocks\n")
    code = textwrap.dedent("""
        import sys, types
        sys.path[:0] = [sys.argv[1]]
        from harness.cell import load
        c = load("int8.tiny")
        names = [m["name"] for m in c.per_layer]
        print(c.mix["clients"], "blocks.tiny" in names,
              c.reader("blocks.tiny")(types.SimpleNamespace(blocks=7)))
    """)
    out = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "benchmark")], capture_output=True,
                         text=True, timeout=60, cwd=tmp_path)
    assert out.stdout.split() == ["2", "True", "7"], out.stderr

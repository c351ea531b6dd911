"""chip_smoke.py's ``tp`` phase rehearsed on the CPU at the goldens shape,
and the size of the lines that end a whole run: the summary line stays
under ``SUMMARY_BYTES`` with every phase's seconds and launches, and with
the kernels line and the ok line it stays about 12 KB, well inside the last
24 KB of output a run's record keeps."""

import json

import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import RwkvConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def phase():
    cfg = RwkvConfig(**chip_smoke.GOLDENS_CFG)
    return cfg, chip_smoke.tp(
        torch, cfg, "cpu", chip_smoke.os.path.dirname(
            chip_smoke.os.path.abspath(chip_smoke.__file__)),
        max_tokens=4, tps=(1, 2),
        smoke_argv=["--layers", "2", "--embd", "128", "--steps", "3",
                    "--batch", "2", "--iters", "1", "--tp", "2"])


def test_tp_phase_at_the_goldens_shape(phase):
    cfg, out = phase
    assert out["goldens"] == {"exact": 4, "parted": []}
    for layout in ("f32", "bf16", "int8"):
        assert out["steps"][layout][1]["bitwise"], layout
    assert out["steps"]["f32"][2]["logits_rel_err"] < 1e-5
    # each bf16 / int8 limit lies below its planted faults' readings
    for layout, sep in out["separation"].items():
        tol = chip_smoke.TP_LOW_TOL[layout]
        assert set(sep["faults"]) == {"global_group_norm"} | (
            {"rotate_scales"} if layout == "int8" else set())
        for f in sep["faults"].values():
            assert f[0] > tol[0] or f[1] > tol[1], layout
    assert out["bytes"]["bf16"]["shard"] * 2 == out["bytes"]["bf16"]["whole"]
    sv = out["serving"]
    assert sv["same"] == 4 and sv["lengths"] == [4] * 4
    assert sum(out["launches"].values()) == 0      # the CPU launches none
    sm = out["smoke"]
    assert {"plain", "tp1", "tp2", "tp11_minus_plain"} <= set(sm)
    assert sm["tp2"]["device_ms"] is None          # no device measured
    lines = chip_smoke.tp_lines(out, {}, cfg, "cpu")
    assert len(lines) == 5 and lines[0].startswith("tp: tests/goldens.json")


# the phases whose launches main() reads as a path
PATHS = ("tools", "parity", "tp", "main_path", "cloning", "quantized",
         "streaming", "server", "checkpoint")


def worst_summary(tp_entry):
    """Every phase's summary entry with more readings than main() notes,
    each at its longest (17-digit floats, lists of 8), seven kernels with
    six-digit launch counts on each path (the tools path launches seven
    kernels, the others two to four), and the tp phase's readings from the
    rehearsal."""
    x = 0.12345678901234567
    launches = {k: 123456 for k in list(chip_smoke.launch_counts())[:7]}
    entries = {"build": {"s": x, "sources": 7}}
    for name in chip_smoke.PHASES:
        entries[name] = {"s": 1234.5678901234,
                         "ms": {k: x for k in chip_smoke.KERNEL_ENTRIES},
                         "rtf": [x] * 8, "step_ms": [x, x],
                         "first_line_ms": [x] * 8,
                         "times_s": {f"step {i}": x for i in range(10)}}
        if name in PATHS:
            entries[name]["launches"] = launches
    entries["tp"] = dict(tp_entry, launches=launches)
    return entries


def test_summary_line_holds_its_budget(phase):
    cfg, out = phase
    sm = out["smoke"]
    tp_entry = {"s": out["wall_s"], "goldens_exact": 4, "parted": 0,
                "step_err": {f"{lay} tp{k}": r["logits_rel_err"]
                             for lay, rows in out["steps"].items()
                             for k, r in rows.items()},
                "tax_ms": sm["tp11_minus_plain"],
                "serving_s": [out["serving"]["static_s"],
                              out["serving"]["continuous_s"]]}
    entries = worst_summary(tp_entry)
    line = chip_smoke.summary_line(entries)
    assert len(line.encode()) <= chip_smoke.SUMMARY_BYTES
    got = json.loads(line)["summary"]
    assert list(got) == list(entries)
    for name, e in got.items():
        assert "s" in e, name
        if "launches" in entries[name]:
            assert e["launches"] == entries[name]["launches"], name
    # a summary that fits keeps every reading, rounded
    small = chip_smoke.summary_line({"tp": tp_entry})
    assert "cut" not in json.loads(small)["summary"]["tp"]


def test_run_tail_fits_the_kept_output():
    """The summary, the kernels line (every entry, a launch count on every
    path) and the ok line: about 12 KB."""
    x = 0.040559900000000065
    stats = {name: {"max_abs_err": x, "ms": x, "plain_ms": x, "bound_ms": x,
                    "bound_by": "bytes", "library_ms": x,
                    "note": "n" * 200 if name == "conv1d" else None}
             for name in chip_smoke.KERNEL_ENTRIES}
    for s in stats.values():
        if s["note"] is None:
            del s["note"]
    paths = {p: {k: 1234567 for k in chip_smoke.KERNEL_ENTRIES}
             for p in PATHS}
    kernels = json.dumps({"kernels": chip_smoke.kernel_entries(stats,
                                                               paths)})
    ok = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}})
    tail = chip_smoke.SUMMARY_BYTES + len(kernels) + len(ok) + 3
    assert tail < 13 * 1024, tail

"""The port's kernel-attribution tools (``rwkv_tts_tpu_torch/tools``) run on
the CPU at the goldens config (2 layers × 128): each ``main`` prints one
JSON line holding every piece it times, a CPU run names no device time, and
no kernel is launched."""

import json
import re

import pytest
import torch

from rwkv_tts_tpu_torch.ops import wkv7 as W
from rwkv_tts_tpu_torch.ops import quant as Q
from rwkv_tts_tpu_torch.tools import (profile_conv1d, profile_prefill,
                                      profile_prefill_pieces, profile_qgemm,
                                      profile_stack_kernel,
                                      profile_step_fused,
                                      profile_step_pieces)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TIMES = {"wall_ms", "device_ms"}
CASES = {
    "stack_kernel": (
        profile_stack_kernel,
        ["--batch", "2", "--layers", "2", "--heads", "2", "--steps", "2",
         "--iters", "1"]),
    "step_pieces": (
        profile_step_pieces,
        ["--batch", "2", "--layers", "2", "--embd", "128", "--steps", "2",
         "--iters", "1"]),
    "prefill_pieces": (
        profile_prefill_pieces,
        ["--batch", "2", "--T", "16", "--layers", "2", "--embd", "128",
         "--iters", "1"]),
    "qgemm_int8": (
        profile_qgemm, ["--kind", "int8", "--batch", "2", "--embd", "128",
                        "--iters", "1"]),
    "qgemm_int4": (
        profile_qgemm, ["--kind", "int4", "--batch", "2", "--embd", "128",
                        "--iters", "1"]),
    "step_fused": (
        profile_step_fused, ["--shapes", "2,f32", "1,bf16,3", "--heads", "2",
                             "--iters", "1", "--cold-mb", "1"]),
}


def times_in(obj):
    """Every {"wall_ms", "device_ms"} pair in a tool's result."""
    if isinstance(obj, dict):
        if set(obj) == TIMES:
            yield obj
        else:
            for v in obj.values():
                yield from times_in(v)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tool_runs_on_the_cpu(name, capsys):
    module, argv = CASES[name]
    W.reset_launches()
    Q.reset_launches()
    out = module.main(argv, device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == json.loads(json.dumps(out))
    assert out["device"] == "cpu"
    assert not any(out["launches"].values())
    assert not any(W.LAUNCHES.values()) and not any(Q.LAUNCHES.values())
    if name.startswith("qgemm"):
        # each product of the layer with its byte bound and the plan the
        # kernel would take; no K-split variants without a card
        kind = name.split("_")[1]
        assert set(out["products"]) == set(
            profile_qgemm.layer_shapes(kind, 128))
        for p in out["products"].values():
            assert p["bound_ms"] > 0 and p["plan"]["regime"] == "decode"
            assert "splits_ms" not in p
    elif name == "stack_kernel":
        got = out["batches"]["2"]
        assert set(got["variants"]) == {"serve", "serve_nok", "merged",
                                        "merged_nok"}
        assert {"state_floor_ms", "per_call_overhead_ms", "kernel_serve_ms",
                "kernel_merged_ms"} <= set(got)
    elif name == "step_fused":
        # each shape's bound and the kernel's launch; the plain version's
        # host time, no kernel time
        assert [(r["B"], r["state"], r["slots"])
                for r in out["shapes"].values()] == [(2, "f32", 2),
                                                     (1, "bf16", 3)]
        for row in out["shapes"].values():
            assert row["ms"] is None and "turns" not in row
            assert row["launch"] == {"blocks": 2 * row["B"], "threads": 128,
                                     "thread_rows": 4}
            assert row["bound_ms"] == profile_step_fused.step_bound(
                row["B"], 2, 4 if row["state"] == "f32" else 2)[0] > 0
        with pytest.raises(ValueError, match="card"):
            module.main(["--shapes", "2,f32", "--against", "."],
                        device="cpu")
    elif name == "step_pieces":
        got = out["batches"]["2"]
        assert {"soup", "lora", "sampler", "wkv_out", "wkv_in",
                "wkv_out_minus_in"} <= set(got)
    else:
        got = out["T"]["16"]
        assert {"forward_lengths", "forward_no_lengths", "wkv_dispatch",
                "seq", "wy", "pair", "phase_a_wy", "phase_a_pair",
                "combine"} <= set(got)
        assert (got["wy_chunk"], got["pair_chunk"]) == (16, 4)
    # host-clock times (differences of them may be negative), no device time
    times = list(times_in(out))
    assert times and all(t["device_ms"] is None
                         and isinstance(t["wall_ms"], float) for t in times)


@pytest.mark.parametrize("call,want", [
    # the input conv: 22 MB of packed bf16 weights set the bound
    ((1024, 1536, 202, 7, 1, "bare"),
     (4 * (1024 * 202 + 1536 + 1536 * 202) + 2 * 1536 * 1024 * 7, "bytes")),
    # a residual unit's k = 7 conv at 384 channels: the tensor cores
    ((384, 384, 8080, 7, 3, "snake"), (2.0 * 7 * 384 * 384 * 8080,
                                       "operations")),
    # a k = 1 conv: x, residual and y in f32 beside a small weight
    ((96, 96, 64640, 1, 1, "snake_res"),
     (4 * (96 * 64640 + 96 + 2 * 96 * 64640 + 96) + 2 * 96 * 96, "bytes")),
], ids=["input conv", "k7", "k1 residual"])
def test_conv_bound_counts_what_the_call_must_move(call, want):
    """The one bound formula of a conv1d call (the tool's, which
    ``chip_smoke.py`` uses): the packed bf16 weight at 2 bytes an element,
    every f32 operand read once and y written once, against 2·K·Ci·O·T
    operations; 3.35 TB/s and 989 TFLOP/s bf16 (H100 SXM)."""
    amount, by = want
    rate = 3.35e12 if by == "bytes" else 989e12
    Ci, O, T, K, _, variant = call
    ms, got_by = profile_conv1d.conv_bound(Ci, O, T, K, variant)
    assert got_by == by
    assert ms == pytest.approx(amount / rate * 1e3, rel=1e-12)
    # the f32 weights as stored cost 2 bytes more an element
    stored = profile_conv1d.conv_bound(Ci, O, T, K, variant, w_bytes=4)[0]
    assert stored >= ms
    if by == "bytes":
        assert (stored - ms) * 3.35e12 / 1e3 == pytest.approx(
            2 * O * Ci * K, rel=1e-9)


@pytest.mark.parametrize("window", [8, 28])
def test_profile_conv1d_runs_on_the_cpu(window, capsys):
    """The conv1d tool on the CPU: each distinct kernel call of the window
    with its bound and the plan ``conv1d_plan`` picks, no time, nothing
    launched."""
    import dataclasses

    from rwkv_tts_tpu_torch.config import BiCodecConfig
    from rwkv_tts_tpu_torch.models import bicodec
    from rwkv_tts_tpu_torch.ops import conv1d as C1

    out = profile_conv1d.main(["--window", str(window), "--dec-channels",
                               "384"], device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == json.loads(json.dumps(out))
    assert out["device"] == "cpu" and not any(out["launches"].values())
    assert not any(C1.LAUNCHES.values())
    cfg = dataclasses.replace(BiCodecConfig(), dec_channels=384)
    calls = bicodec.kernel_conv_calls(cfg, window)
    assert len(out["calls"]) == len(set(calls)) and "window_ms" not in out
    for row in out["calls"].values():
        assert row["plan_ms"] is None
        Ci, O, T, K = (int(v) for v in re.findall(r"\d+", row["call"])[:4])
        variant = row["call"].rsplit(" ", 1)[1]
        assert row["bound_ms"] == profile_conv1d.conv_bound(Ci, O, T, K,
                                                            variant)[0] > 0
        assert row["plan"]["regime"] in ("tile", "cluster")
        assert 1 <= row["plan"]["cluster"] <= 8


@pytest.mark.parametrize("B,T", [(8, 64), (128, 64)])
def test_seq_bound_counts_what_the_call_must_move(B, T):
    """The sequential prefill's bound (the tool's, which ``chip_smoke.py``
    counts the same way): six [B, T, 32, 64] f32 inputs and y once, the
    f32 state in and out once, at 3.35 TB/s; 9 f32 operations a state
    element and token at 67 TFLOP/s are less."""
    H, N = 32, 64
    ms, by = profile_prefill.seq_bound(B, T, H)
    nbytes = 7 * B * T * H * N * 4 + 2 * B * H * N * N * 4
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert 9 * B * T * H * N * N / 67e12 * 1e3 < ms


@pytest.mark.parametrize("B,state_bytes", [(8, 4), (8, 2), (128, 4),
                                           (128, 2)])
def test_step_bound_counts_what_the_call_must_move(B, state_bytes):
    """The fused step's bound (the tool's, which ``chip_smoke.py`` counts
    the same way): the layer's [B, 32, 64, 64] state slab in and out once,
    r, k, v (bf16) and lo_w, lo_a, lo_v, g, v_first (f32) read once,
    params8 [8, 32, 64] f32 once and out [B, 32, 64] f32 once, at 3.35 TB/s;
    9 f32 operations a state element at 67 TFLOP/s take less. At B = 8, f32
    state, that is row 8's 0.00267 ms."""
    H, N = 32, 64
    ms, by = profile_step_fused.step_bound(B, H, state_bytes)
    nbytes = (2 * B * H * N * N * state_bytes + 3 * B * H * N * 2
              + 5 * B * H * N * 4 + 8 * H * N * 4 + B * H * N * 4)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert 9 * B * H * N * N / 67e12 * 1e3 < ms
    if (B, state_bytes) == (8, 4):
        assert round(ms, 5) == 0.00267


@pytest.mark.parametrize("name", sorted(profile_step_fused.CUTS))
def test_step_fused_cuts_apply_to_the_source(name):
    """Every cut of the fused step's source finds its markers in the
    committed kernel and changes it; without a card ``--cut`` is
    refused."""
    src = (W._build.CSRC / "wkv7_step_fused.cu").read_text()
    cut = profile_step_fused.cut_source(name)
    assert cut != src and 'extern "C" int wkv7_step_fused(' in cut
    with pytest.raises(ValueError, match="card"):
        profile_step_fused.main(["--shapes", "1,f32", "--cut", name],
                                device="cpu")


def test_profile_prefill_runs_on_the_cpu(capsys):
    """The sequential prefill tool on the CPU: each shape's plan, bound and
    shared memory, no time, nothing launched; builds of other sources are
    refused without a card."""
    out = profile_prefill.main(["--shapes", "1,3", "8,64", "130,64"],
                               device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == json.loads(json.dumps(out))
    assert out["device"] == "cpu" and not any(out["launches"].values())
    for row in out["shapes"]:
        assert row["ms"] is None
        assert row["plan"] == W.prefill_plan(row["B"], row["T"], 32)
        assert 0 < row["smem"] <= W.SMEM_LIMIT
        assert row["bound_ms"] == profile_prefill.seq_bound(
            row["B"], row["T"], 32)[0]
    with pytest.raises(ValueError, match="card"):
        profile_prefill.main(["--shapes", "1,3", "--variant", "2"],
                             device="cpu")


def test_wy_bound_counts_what_the_call_must_move():
    """WY phase A at the cloning prompt's (8, 256, L = 64): six inputs and
    y_loc, rho once (8 · B·T·H·64 f32) and s_loc, P once
    (2 · B·T/L·H·64² f32) at 3.35 TB/s; its function's 5·L²·N + 3·N²·L
    multiply-adds a cell, three TF32 products each at 495 TFLOP/s, take
    less; at the f32 peak they would take 0.0641 ms. The kernel's algorithm
    runs 2,355,200 multiply-adds a cell (rows in blocks of 16)."""
    B, T, H, N, L = 8, 256, 32, 64, 64
    ms, by, f32_ms = profile_prefill.wy_bound(B, T, H, L)
    nbytes = 8 * B * T * H * N * 4 + 2 * B * (T // L) * H * N * N * 4
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    flops = profile_prefill.wy_flops(B, T, H, L)
    assert flops == 2 * (5 * L * L * N + 3 * N * N * L) * B * (T // L) * H
    assert 3 * flops / 495e12 * 1e3 < ms
    assert f32_ms == pytest.approx(flops / 67e12 * 1e3, rel=1e-12)
    assert profile_prefill.wy_algorithm_flops(B, T, H, L) == \
        2 * 2355200 * B * (T // L) * H
    # below 16 rows, 16 / L cells share a tile: at L = 4, 514 cells in 129
    # tiles of one 16-row block (146432 multiply-adds each), and each cell's
    # P and s_loc over one step of 8 positions
    assert profile_prefill.wy_algorithm_flops(2, 1028, H, 4) == \
        2 * (129 * 146432 + 514 * 3 * N * N * 8) * H


def test_pair_bound_counts_what_the_call_must_move():
    """The paired phase A at (8, 256, L = 16): the same bytes as WY's at
    its chunk count; 16 f32 operations a state element and position."""
    B, T, H, N, L = 8, 256, 32, 64, 16
    ms, by = profile_prefill.pair_bound(B, T, H, L)
    nbytes = 8 * B * T * H * N * 4 + 2 * B * (T // L) * H * N * N * 4
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert 16 * B * T * H * N * N / 67e12 * 1e3 < ms


@pytest.mark.parametrize("kernel", ["wy", "pair"])
def test_profile_prefill_chunk_kernels_run_on_the_cpu(kernel, capsys):
    """``--kernel wy`` and ``--kernel pair`` on the CPU: each shape's chunk
    length from the route's chunk rule (shapes it gives none skipped), its
    bound, the pair's plan, no time, nothing launched; ``--variant``
    belongs to the sequential kernel only."""
    out = profile_prefill.main(["--kernel", kernel, "--shapes", "8,256",
                                "2,1028", "1,2048", "1,3"], device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == json.loads(json.dumps(out))
    assert out["kernel"] == kernel and not any(out["launches"].values())
    rule = W.wy_chunk_for if kernel == "wy" else W.prefill_chunk_for
    assert [(r["B"], r["T"]) for r in out["shapes"]] == [
        (8, 256), (2, 1028), (1, 2048)]
    for row in out["shapes"]:
        assert row["ms"] is None and row["L"] == rule(row["T"])
        if kernel == "wy":
            assert row["bound_ms"] == profile_prefill.wy_bound(
                row["B"], row["T"], 32, row["L"])[0]
        else:
            assert row["bound_ms"] == profile_prefill.pair_bound(
                row["B"], row["T"], 32, row["L"])[0]
            assert row["plan"] == W.pair_plan(
                row["B"] * row["T"] // row["L"], row["L"], 32)
    with pytest.raises(ValueError, match="sequential"):
        profile_prefill.main(["--kernel", kernel, "--variant", "2"],
                             device="cpu")

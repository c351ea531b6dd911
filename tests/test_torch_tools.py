"""The port's kernel-attribution tools (``rwkv_tts_tpu_torch/tools``) run on
the CPU at the goldens config (2 layers × 128): each ``main`` prints one
JSON line holding every piece it times, a CPU run names no device time, and
no kernel is launched."""

import json

import pytest
import torch

from rwkv_tts_tpu_torch.ops import wkv7 as W
from rwkv_tts_tpu_torch.ops import quant as Q
from rwkv_tts_tpu_torch.tools import (profile_prefill_pieces, profile_qgemm,
                                      profile_stack_kernel,
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

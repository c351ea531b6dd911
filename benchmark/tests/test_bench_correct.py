"""``correct`` separates: on a tiny cell on the CPU, a sound run passes
(``test_bench_run``), and the control (the program at the configuration's
next lower precisions) and each fault a served cell can have, planted in
the program underneath the harness, come out not correct."""

import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH / "tests"), str(BENCH), str(BENCH.parent)]

import tiny  # noqa: E402
from harness import session  # noqa: E402

from rwkv_tts_tpu_torch.models import rwkv7  # noqa: E402
from rwkv_tts_tpu_torch.runtime.continuous import ContinuousEngine  # noqa: E402

SEED = 2**33 + 11


def _run(workload="int8.backlog", control=False):
    torch.set_num_threads(2)
    return session.run(tiny.tiny_cell(workload), SEED, 2.5, False, "cpu",
                       time.time(), control=control)


def _failed(out):
    return sorted(n for n, c in out["checks"].items()
                  if not c["value"] <= c["limit"])


@pytest.mark.parametrize("workload", ["int8.backlog", "bf16.stream"])
def test_the_control_is_not_correct(workload):
    out = _run(workload, control=True)
    assert out["correct"] is False and _failed(out)


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    step = rwkv7.step

    def unchanged(params, token, state, cfg, head_slice=None):
        saved = {k: v.clone() for k, v in state.items()}
        logits, _ = step(params, token, state, cfg, head_slice=head_slice)
        for k, v in saved.items():
            state[k].copy_(v)
        return logits, state

    monkeypatch.setattr(rwkv7, "step", unchanged)
    out = _run()
    assert out["correct"] is False and "token_gap" in _failed(out)


def test_half_the_batch_left_out(monkeypatch):
    step = rwkv7.step

    def half(params, token, state, cfg, head_slice=None):
        logits, state = step(params, token, state, cfg,
                             head_slice=head_slice)
        h = logits.shape[0] // 2
        if h:
            rest = logits[:h].mean(0, keepdim=True)
            logits = torch.cat([logits[:h],
                                rest.expand(logits.shape[0] - h, -1)])
        return logits, state

    monkeypatch.setattr(rwkv7, "step", half)
    out = _run()
    assert out["correct"] is False and "token_gap" in _failed(out)


def test_a_token_altered_where_it_is_produced(monkeypatch):
    retire = ContinuousEngine._retire

    def altered(self, slot):
        live = self._live.get(slot)
        if live is not None and live.semantic_tokens:
            i = len(live.semantic_tokens) // 2
            live.semantic_tokens[i] = (live.semantic_tokens[i] + 4096) % 8192
        retire(self, slot)

    monkeypatch.setattr(ContinuousEngine, "_retire", altered)
    out = _run()
    assert out["correct"] is False and "token_gap" in _failed(out)

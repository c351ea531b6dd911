"""A cell at CPU-test size: the harness's real pieces around a 2-layer,
64-wide LM (full vocabulary) and the tiny BiCodec, a few slots."""

from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.cell import Cell, load  # noqa: E402


def tiny_cell(workload: str = "int8.backlog", **mix_over) -> Cell:
    """``workload``'s cell with its model cut to test size (widths and
    depth; the layouts, precisions and limits kept) and its traffic to a
    few slots and short requests."""
    from rwkv_tts_tpu_torch.config import BiCodecConfig
    cell = load(workload)
    cfg = copy.deepcopy(cell.config)
    cfg["lm"].update(n_layer=2, n_embd=128, decay_lora=16, a_lora=16,
                     v_lora=16, gate_lora=16)
    cfg["codec"] = {k: (list(v) if isinstance(v, tuple) else v) for k, v in
                    dataclasses.asdict(BiCodecConfig.tiny()).items()}
    mix = dict(cell.mix, slots=4, block=4, words=[2, 4], tokens_per_word=4,
               ramp_s=1.0, drain_s=20.0, trace_s=0.5, min_request_s=0.2)
    if mix["loop"] == "closed":
        mix["clients"] = 4
    else:
        mix["rate_per_s"] = 4.0
    mix.update(mix_over)
    return dataclasses.replace(cell, config=cfg, mix=mix)

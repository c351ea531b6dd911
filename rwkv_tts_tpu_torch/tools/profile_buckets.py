"""Decode-block ms a step per occupancy bucket in the serving layout: the
port's counterpart of the JAX package's ``tools/profile_buckets.py``, the
data behind the continuous engine's bucket and compaction policy
(``runtime/continuous.py``).

The layout is the JAX tool's: ``rwkv7.make_serving_params`` (int8 weights,
the raw projections) with a bf16 state, ``slots`` slots all in the
semantic stage with no limit in sight. For each occupancy bucket of (8,
16, 32, 64, slots) up to ``slots`` it times a block of ``block`` steps:
``decode_block_bucketed`` on the first ``bucket`` slots
(``decode_block`` on all of them at bucket = slots), eagerly and, on a
card, replayed as ``continuous.BlockGraphs``, the counterpart of the JAX
tool's jitted block. It prints the JAX tool's line per bucket, from the
graphed block on a card and from the eager one on the CPU::

    bucket    8:   x.xxx ms/step (    y.y ms/block of 32)

then one JSON line: per bucket both walls a step, and on a card the graphed
block's device busy ms and kernels a step (over its draws and two steps,
``torch.profiler``) and the capture's seconds.

    python -m rwkv_tts_tpu_torch.tools.profile_buckets [slots] [block]
        [--iters 4] [--layers 32] [--embd 2048]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Optional, Sequence

import torch

from .. import constants as C
from ..config import RwkvConfig
from ..models import rwkv7
from ..runtime import continuous as CT
from ..runtime.engine import SEMANTIC_SLICE
from ..utils.device import resolve_device
from ._timing import Launches, busy, card_name, wall

BUCKETS = (8, 16, 32, 64)


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_buckets",
                                description=__doc__.splitlines()[0])
    p.add_argument("slots", type=int, nargs="?", default=128)
    p.add_argument("block", type=int, nargs="?", default=32)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--layers", type=int, default=RwkvConfig.n_layer)
    p.add_argument("--embd", type=int, default=RwkvConfig.n_embd)
    return p.parse_args(argv)


def serving_cfg(layers: int, embd: int) -> RwkvConfig:
    """The JAX tools' serving configuration: the model's widths with a
    bf16 state."""
    return dataclasses.replace(RwkvConfig(n_layer=layers, n_embd=embd),
                               state_dtype="bfloat16")


def serving_params(cfg: RwkvConfig, device: torch.device):
    """``make_serving_params`` (int8, raw) from seed 0 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return rwkv7.make_serving_params(cfg, gen, quant="int8", device=device)


def semantic_slots(B: int, device) -> Dict[str, torch.Tensor]:
    """The JAX tool's slots: every slot semantic, past its global tokens,
    with a limit far beyond any block."""
    s = CT.init_slots(B, device)
    s["stage"].fill_(CT.SEMANTIC)
    s["n_glob"].fill_(C.GLOBAL_TOKENS_SIZE)
    s["limit"].fill_(1 << 20)
    s["hard_min"].fill_(1 << 20)
    return s


def buckets_of(slots: int):
    return [b for b in BUCKETS if b < slots] + [slots]


def profile(cfg: RwkvConfig, params, slots: int, block: int, iters: int,
            device: torch.device) -> Dict[str, Dict]:
    B = slots
    width = min(SEMANTIC_SLICE, cfg.padded_vocab_size)
    state = rwkv7.init_state(cfg, B, device=device)
    logits = torch.zeros((B, width), dtype=torch.float32, device=device)
    out: Dict[str, Dict] = {}
    bg = None
    if device.type == "cuda":
        # the graphs' own buffers, as an engine's
        g_state = rwkv7.init_state(cfg, B, device=device)
        bg = CT.BlockGraphs(params, cfg, g_state, logits.clone(),
                            semantic_slots(B, device), block)
    for bucket in buckets_of(slots):
        slots_d = semantic_slots(B, device)
        if bucket == B:
            def run(st, lg, sl):
                return CT.decode_block(params, st, lg, sl, cfg, block)
        else:
            def run(st, lg, sl, bk=bucket):
                return CT.decode_block_bucketed(params, st, lg, sl, cfg,
                                                block, bk)
        carry = {"lg": logits, "sl": slots_d}

        def eager():
            _, carry["lg"], carry["sl"], em = run(state, carry["lg"],
                                                 carry["sl"])
            return em

        r = {"eager_ms_per_step": wall(eager, iters, device, per=block)}
        if bg is not None:
            before = len(bg.cache.programs)
            draws, step = bg.programs(bucket)
            r["capture_s"] = sum(
                p.stats["warmup_s"] + p.stats["capture_s"]
                + p.stats["instantiate_s"]
                for p in list(bg.cache.programs.values())[before:])
            r["graphed_ms_per_step"] = wall(lambda b=bucket: bg.run(b),
                                            iters, device, per=block)

            def two_steps(d=draws, s=step):
                d.replay()
                s.replay()
                s.replay()

            dev = busy(two_steps, device, per=2)
            r["device_ms_per_step"] = dev["device_ms"]
            r["kernels_per_step"] = dev["kernels"]
        ms = r.get("graphed_ms_per_step", r["eager_ms_per_step"])
        r["ms_per_step"] = ms
        r["ms_per_block"] = ms * block
        print(f"bucket {bucket:4d}: {ms:7.3f} ms/step "
              f"({ms * block:8.1f} ms/block of {block})", flush=True)
        out[str(bucket)] = r
    return out


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    a = _args(argv)
    dev = resolve_device(device)
    cfg = serving_cfg(a.layers, a.embd)
    params = serving_params(cfg, dev)
    launches = Launches()
    out = {"tool": "profile_buckets", "device": card_name(dev),
           "L": cfg.n_layer, "C": cfg.n_embd, "slots": a.slots,
           "block": a.block, "iters": a.iters, "quant": "int8",
           "state_dtype": cfg.state_dtype,
           "buckets": profile(cfg, params, a.slots, a.block, a.iters, dev)}
    out["launches"] = launches.delta()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

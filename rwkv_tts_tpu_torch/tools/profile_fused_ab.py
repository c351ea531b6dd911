"""The decode step's projection layout, fused against raw, at the
throughput batch: the port's counterpart of the JAX package's
``tools/profile_fused_ab.py``.

``rwkv7.fuse_params`` folds the token shift into the products by stacking
[W; diag(mu) W]: half the decode launches, but twice the r/k/v and LoRA-A
weight bytes and multiply-adds (``zrkv`` is [2C, 3C] against 3 × [C, C]).
Both layouts are built by ``rwkv7.make_serving_params`` (int8 weights;
bf16 weights, activations and state, ``state_dtype="bfloat16"``), and each
runs the whole semantic stage as the static engine runs it (``TtsEngine``:
``StageGraphs`` replayed on a card, eager on the CPU) from zero logits,
with TAG_1 fed in first and ``hard_min = steps`` (EOS forbidden): one
untimed call, then ``--iters`` timed ones (3). The JAX tool's docstring
and ``make_serving_params``' give TPU figures for this A/B; none carries
over to the card.

Prints each layout's weight GB, first call seconds, ms a stage and a step
and tok/s, then one JSON line (``batch``, ``steps``, ``fused_ms_step``,
``raw_ms_step``, ``raw_speedup``; on a card each layout's device busy ms
and kernels of one semantic step, ``torch.profiler``).

    python -m rwkv_tts_tpu_torch.tools.profile_fused_ab [batch] [steps]
        [--iters 3] [--layers 32] [--embd 2048]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import RwkvConfig
from ..models import rwkv7
from ..runtime.engine import SEMANTIC_SLICE
from ..utils import threefry
from ..utils.device import resolve_device
from ._timing import Launches, card_name, wall
from .profile_buckets import serving_cfg
from .profile_decode import _nbytes
from .profile_first_chunk import serving_engine, step_busy


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_fused_ab",
                                description=__doc__.splitlines()[0])
    p.add_argument("batch", type=int, nargs="?", default=128)
    p.add_argument("steps", type=int, nargs="?", default=256)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--layers", type=int, default=RwkvConfig.n_layer)
    p.add_argument("--embd", type=int, default=RwkvConfig.n_embd)
    return p.parse_args(argv)


def run(cfg: RwkvConfig, fused: bool, batch: int, steps: int, iters: int,
        tag: str, device: torch.device) -> Dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = rwkv7.make_serving_params(cfg, gen, fused=fused, quant="int8",
                                       device=device)
    gb = _nbytes(params) / 1e9
    eng = serving_engine(params, cfg, batch, steps, device)
    keys = threefry.as_words(np.stack(
        [np.array([0, s], np.uint32) for s in range(batch)])).to(device)
    limits = torch.full((batch,), steps, dtype=torch.int64, device=device)
    logits = torch.zeros((batch, min(SEMANTIC_SLICE, cfg.padded_vocab_size)),
                         dtype=torch.float32, device=device)
    state = eng.init_state(batch)

    def go():
        return eng.run_semantic(state, logits, keys, limits, limits, False,
                                True)

    with eng.stage_lock:
        t0 = time.perf_counter()
        _, lens, _, n = go()
        if int(lens.min()) != steps:
            raise RuntimeError(f"{tag}: EOS is forbidden, yet a row emitted "
                               f"{int(lens.min())} of {steps} tokens")
        first_s = time.perf_counter() - t0
        stage_ms = wall(go, iters, device, warmup=0)
        step = step_busy(eng, (batch, steps, "semantic", False), device)
    ms_step = stage_ms / steps
    print(f"[{tag}] weights {gb:.3f} GB  first call {first_s:.1f}s  "
          f"{stage_ms:.1f} ms/stage  {ms_step:.3f} ms/step  "
          f"{batch * steps / stage_ms * 1e3:.0f} tok/s", flush=True)
    del eng, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"weights_gb": gb, "first_call_s": first_s, "ms_stage": stage_ms,
            "ms_step": ms_step, "tok_s": batch * steps / stage_ms * 1e3,
            "step_busy_ms": step["busy_ms"], "step_kernels": step["kernels"],
            "stage_steps": n}


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    a = _args(argv)
    dev = resolve_device(device)
    cfg = serving_cfg(a.layers, a.embd)
    print(f"device={card_name(dev)}  {cfg.n_layer}Lx{cfg.n_embd}E  "
          f"batch={a.batch} steps={a.steps}", flush=True)
    launches = Launches()
    f = run(cfg, True, a.batch, a.steps, a.iters, "fused+int8", dev)
    r = run(cfg, False, a.batch, a.steps, a.iters, "raw+int8", dev)
    out = {"batch": a.batch, "steps": a.steps,
           "fused_ms_step": f["ms_step"], "raw_ms_step": r["ms_step"],
           "raw_speedup": f["ms_step"] / r["ms_step"],
           "tool": "profile_fused_ab", "device": card_name(dev),
           "L": cfg.n_layer, "C": cfg.n_embd, "iters": a.iters,
           "quant": "int8", "state_dtype": cfg.state_dtype,
           "fused": f, "raw": r, "launches": launches.delta()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

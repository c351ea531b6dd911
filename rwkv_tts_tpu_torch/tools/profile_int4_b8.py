"""int8 against int4 weights end to end at batch 8: the port's counterpart
of the JAX package's ``tools/profile_int4_b8.py``.

Both layouts come from ``rwkv7.make_serving_params`` (the raw projections)
with a bf16 state. Each runs the serving LM program,
``TtsEngine.lm_program`` (a prefill of 64 random tokens in [12293, 40000)
from ``default_rng(0)``, the global stage, TAG_1 and 512 semantic steps
with EOS forbidden; ``PrefillGraphs`` and ``StageGraphs`` replayed on a
card, eager on the CPU), then the full ``bicodec.decode`` of its 8 × 512
tokens. The decode runs eagerly: 8 × 512 latents are past
``bicodec.DECODE_GRAPH_MAX_LATENTS``, where the pipeline's
``DecodeGraphs`` runs eagerly too. One untimed call each, then ``--iters``
timed ones (3).

One JSON line per run with the JAX tool's keys per layout (``wall_s_lm``,
``wall_s_detok``, ``step_ms``, ``rtf_e2e_batch8``, ``xrt_e2e_batch8``) and
``int4_wins``. The JAX tool's ``meets_002_line`` held the TPU to an RTF of
0.025; no TPU figure is a target here, so ``meets_rtf_limit`` holds the
better layout to the project's RTF < 0.3 (the reference server's alert
threshold). On a card each layout also gives the device busy ms and
kernels of one semantic step (``torch.profiler``).

    python -m rwkv_tts_tpu_torch.tools.profile_int4_b8 [--steps 512]
        [--iters 3] [--layers 32] [--embd 2048] [--tiny-codec]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence

import torch

from .. import constants as C
from ..config import RwkvConfig
from ..models import bicodec, rwkv7
from ..utils.device import resolve_device
from ._timing import Launches, card_name, wall
from .profile_buckets import serving_cfg
from .profile_first_chunk import (program_inputs, serving_codec,
                                  serving_engine, step_busy)

BATCH = 8
RTF_LIMIT = 0.3


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_int4_b8",
                                description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=512)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--layers", type=int, default=RwkvConfig.n_layer)
    p.add_argument("--embd", type=int, default=RwkvConfig.n_embd)
    p.add_argument("--tiny-codec", action="store_true",
                   help="BiCodecConfig.tiny() instead of the full codec")
    return p.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: RwkvConfig, quant: str, bc, bc_cfg, steps: int, iters: int,
        device: torch.device) -> Dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = rwkv7.make_serving_params(cfg, gen, quant=quant, device=device)
    eng = serving_engine(params, cfg, BATCH, steps, device)
    prompts, keys, limits = program_inputs(BATCH, steps, device)
    box = {}

    def lm():
        box["lm"] = eng.lm_program(prompts, keys, keys, limits, limits,
                                   False)

    def detok():
        glob, sem, _ = box["lm"]
        box["wav"] = bicodec.decode(bc, glob, sem, bc_cfg)

    t0 = time.perf_counter()
    lm()
    _sync(device)
    first_s = time.perf_counter() - t0
    if int(box["lm"][2].min()) != steps:
        raise RuntimeError(f"{quant}: EOS is forbidden, yet a row emitted "
                           f"{int(box['lm'][2].min())} of {steps} tokens")
    detok()
    wall_lm = wall(lm, iters, device, warmup=0) / 1e3
    wall_detok = wall(detok, iters, device, warmup=0) / 1e3
    if not bool(torch.isfinite(box["wav"]).all()):
        raise RuntimeError(f"{quant}: the waveform is not finite")
    audio_s = BATCH * steps / C.TOKENS_PER_SECOND
    step = step_busy(eng, (BATCH, steps, "semantic", False), device)
    out = {
        "wall_s_lm": wall_lm,
        "wall_s_detok": wall_detok,
        "step_ms": wall_lm / (C.GLOBAL_TOKENS_SIZE + steps) * 1e3,
        "rtf_e2e_batch8": (wall_lm + wall_detok) / audio_s,
        "xrt_e2e_batch8": audio_s / (wall_lm + wall_detok),
        "first_call_s": first_s,
        "step_busy_ms": step["busy_ms"], "step_kernels": step["kernels"],
        "detok": "eager",
    }
    del eng, params, box
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    a = _args(argv)
    dev = resolve_device(device)
    cfg = serving_cfg(a.layers, a.embd)
    bc, bc_cfg = serving_codec(a.tiny_codec, dev)
    launches = Launches()
    out = {"tool": "profile_int4_b8", "backend": dev.type,
           "device": card_name(dev), "L": cfg.n_layer, "C": cfg.n_embd,
           "batch": BATCH, "steps": a.steps, "iters": a.iters,
           "state_dtype": cfg.state_dtype,
           "codec": "tiny" if a.tiny_codec else "full"}
    for quant in ("int8", "int4"):
        out[quant] = run(cfg, quant, bc, bc_cfg, a.steps, a.iters, dev)
        print(f"# {quant}: {out[quant]}", file=sys.stderr, flush=True)
    i8, i4 = out["int8"]["rtf_e2e_batch8"], out["int4"]["rtf_e2e_batch8"]
    out["int4_wins"] = bool(i4 < i8)
    out["rtf_limit"] = RTF_LIMIT
    out["meets_rtf_limit"] = bool(min(i4, i8) < RTF_LIMIT)
    out["launches"] = launches.delta()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

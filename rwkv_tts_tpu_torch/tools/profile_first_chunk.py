"""First-chunk latency split by stage, in the serving layout: the port's
counterpart of the JAX package's ``tools/profile_first_chunk.py``.

The configuration is the JAX tool's: ``rwkv7.make_serving_params`` (int8
weights, the raw projections) with a bf16 state, batch 8, a prefill of 64
random tokens in [12293, 40000) from ``default_rng(0)``, the 32-step global
stage, TAG_1 plus 48 semantic steps with ``hard_min = steps`` (EOS
forbidden, so every step runs), and one 80-latent BiCodec window at B = 1.
Each stage is timed as the static engine runs it (``TtsEngine``:
``PrefillGraphs`` and ``StageGraphs`` replayed on a card, eager on the
CPU; the window through ``bicodec.DecodeGraphs`` on a card). Then
``TtsEngine.lm_program``, the same chain in one call, is timed against the
sum of the stages: the JAX tool's "dispatch glue". Here both sides replay
the same programs, so the difference is only what timing each stage on its
own adds (a sync and a host gap before each); the port has no dispatch
between graphs to save.

It prints the JAX tool's lines, then one JSON line: per stage wall ms
(CUDA events on a card, the host clock on the CPU) and, on a card, device
busy ms and kernels (``torch.profiler`` over one replay of each stage's
step program, times its steps; the step counter's reset is one of the
kernels); and ``fused_lm_ms``, ``staged_lm_ms``, ``glue_ms``.

    python -m rwkv_tts_tpu_torch.tools.profile_first_chunk [batch]
        [sem_steps] [--iters 5] [--layers 32] [--embd 2048] [--tiny-codec]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from ..config import BiCodecConfig, EngineConfig, RwkvConfig
from ..models import bicodec
from ..runtime.engine import TtsEngine
from ..utils import threefry
from ..utils.device import resolve_device
from ._timing import Launches, busy, card_name, wall
from .profile_buckets import serving_cfg, serving_params

PREFILL = 64
WINDOW = 32 + 16 + 32      # the streaming window the JAX tool decodes
NONE = {"busy_ms": None, "kernels": None}


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_first_chunk",
                                description=__doc__.splitlines()[0])
    p.add_argument("batch", type=int, nargs="?", default=8)
    p.add_argument("sem_steps", type=int, nargs="?", default=48)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--layers", type=int, default=RwkvConfig.n_layer)
    p.add_argument("--embd", type=int, default=RwkvConfig.n_embd)
    p.add_argument("--tiny-codec", action="store_true",
                   help="BiCodecConfig.tiny() instead of the full codec")
    return p.parse_args(argv)


def serving_codec(tiny: bool, device: torch.device):
    """The tools' BiCodec from seed 1 (full size, or ``BiCodecConfig.tiny``),
    prepared as the pipeline prepares it; returns (params, cfg)."""
    cfg = BiCodecConfig.tiny() if tiny else BiCodecConfig()
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    return bicodec.prepare_params(bicodec.init_params(cfg, gen, device),
                                  cfg), cfg


def serving_engine(params, cfg: RwkvConfig, batch: int, max_steps: int,
                   device: torch.device) -> TtsEngine:
    """A static engine whose semantic stage runs ``max_steps`` steps, with
    the one prefill bucket the JAX tools' 64-token prompts take."""
    return TtsEngine(params, cfg, EngineConfig(
        batch_size=batch, max_semantic_tokens=max_steps,
        prefill_buckets=(PREFILL,)), device=device)


def program_inputs(batch: int, steps: int, device: torch.device):
    """The JAX tools' inputs: (B prompts of 64 token ids; keys [B, 2] =
    [0, b] and limits [B] = steps on ``device``)."""
    prompts = np.random.default_rng(0).integers(
        12293, 40000, (batch, PREFILL)).tolist()
    keys = threefry.as_words(np.stack(
        [np.array([0, s], np.uint32) for s in range(batch)])).to(device)
    limits = torch.full((batch,), steps, dtype=torch.int64, device=device)
    return prompts, keys, limits


def busy_of(fn: Callable[[], object], device: torch.device) -> Dict:
    """``_timing.busy`` of one call, as busy ms and kernels."""
    b = busy(fn, device)
    return {"busy_ms": b["device_ms"], "kernels": b["kernels"]}


def step_busy(eng: TtsEngine, key, device: torch.device) -> Dict:
    """Device busy ms and kernels of one replay of the engine's captured
    stage program ``key`` (``StageGraphs``: (B, "global"), (B, "tag1"),
    (B, steps, "semantic", zero-shot)), its step counter reset first so
    that the replay reads a column in range. None on the CPU."""
    if eng.graphs is None:
        return dict(NONE)
    prog = eng.graphs.cache.programs[key]
    i = eng.graphs.sets[key[0]]["i"]

    def one():
        i.zero_()
        prog.replay()
    return busy_of(one, device)


def scaled(b: Dict, n: int) -> Dict:
    return {k: None if v is None else v * n for k, v in b.items()}


def summed(*bs: Dict) -> Dict:
    return {k: None if any(b[k] is None for b in bs)
            else sum(b[k] for b in bs) for k in bs[0]}


def first_then_wall(fn: Callable[[], object], iters: int, tag: str,
                    device: torch.device, box: Optional[Dict] = None
                    ) -> Dict:
    """The first call's seconds (on a card: its captures) and the wall ms
    per call of ``iters`` more; ``box["first"]`` takes the first call's
    return."""
    t0 = time.perf_counter()
    first_out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    first = time.perf_counter() - t0
    if box is not None:
        box["first"] = first_out
    print(f"  [{tag}] first call (captures) in {first:.1f}s", flush=True)
    return {"first_s": first, "wall_ms": wall(fn, iters, device, warmup=0)}


def profile(cfg: RwkvConfig, params, bc, bc_cfg, batch: int, steps: int,
            iters: int, device: torch.device) -> Dict:
    eng = serving_engine(params, cfg, batch, steps, device)
    prompts, keys, limits = program_inputs(batch, steps, device)
    hard_min = limits
    vocoder = bicodec.decode_graphs(bc, bc_cfg)
    out: Dict[str, Dict] = {}
    box: Dict[str, object] = {}

    def prefill():
        box["logits"], box["state"] = eng.prefill(prompts,
                                                  eng.init_state(batch))

    out["prefill"] = first_then_wall(prefill, iters, "prefill", device)
    out["prefill"].update(
        busy_of(eng.prefill_graphs.cache.programs[(batch, PREFILL)].replay,
                device) if eng.prefill_graphs is not None else NONE)
    with eng.stage_lock:
        def glob():
            return eng.run_global(box["state"], box["logits"], keys)

        out["global"] = first_then_wall(glob, iters, "global32", device)
        out["global"].update(scaled(step_busy(eng, (batch, "global"),
                                              device), C.GLOBAL_TOKENS_SIZE))
        _, state2, logits2 = glob()

        def sem():
            return eng.run_semantic(state2, logits2, keys, limits, hard_min,
                                    False, True)

        out["semantic"] = first_then_wall(sem, iters, f"semantic{steps}+tag1",
                                          device)
        out["semantic"].update(summed(
            step_busy(eng, (batch, "tag1"), device),
            scaled(step_busy(eng, (batch, steps, "semantic", False), device),
                   steps)))
    g_toks = np.zeros((1, C.GLOBAL_TOKENS_SIZE), np.int64)
    sem_win = np.zeros((1, WINDOW), np.int64)

    def vocode():
        return bicodec.decode_host(bc, g_toks, sem_win, bc_cfg, vocoder)

    out["vocode"] = first_then_wall(vocode, iters, f"vocode{WINDOW}", device)
    out["vocode"].update(busy_of(vocoder.cache.programs[(1, WINDOW)].replay,
                                 device) if vocoder is not None else NONE)

    def fused():
        return eng.lm_program(prompts, keys, keys, limits, hard_min, False)

    out["lm_program"] = first_then_wall(fused, iters, "fused_lm", device,
                                        box)
    _, _, lens = box["first"]
    if int(lens.min()) != steps:
        raise RuntimeError(f"EOS is forbidden, yet a row emitted "
                           f"{int(lens.min())} of {steps} semantic tokens")
    return out


def report(o: Dict, steps: int) -> Dict:
    """The JAX tool's lines; returns the LM sums."""
    ms = {k: v["wall_ms"] for k, v in o.items()}
    staged = ms["prefill"] + ms["global"] + ms["semantic"]
    fused = ms["lm_program"]
    print(f"fused LM program: {fused:8.1f} ms vs staged {staged:.1f} ms "
          f"(dispatch glue {staged - fused:+.1f} ms)")
    total = staged + ms["vocode"]
    print(f"\nprefill({PREFILL})   : {ms['prefill']:8.1f} ms")
    print(f"global (32)   : {ms['global']:8.1f} ms  "
          f"({ms['global'] / C.GLOBAL_TOKENS_SIZE:.2f} ms/step)")
    print(f"semantic({steps}+TAG_1): {ms['semantic']:8.1f} ms  "
          f"({ms['semantic'] / (steps + 1):.2f} ms/step)")
    print(f"vocode window : {ms['vocode']:8.1f} ms")
    print(f"TOTAL         : {total:8.1f} ms", flush=True)
    return {"fused_lm_ms": fused, "staged_lm_ms": staged,
            "glue_ms": staged - fused, "total_ms": total}


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    a = _args(argv)
    dev = resolve_device(device)
    cfg = serving_cfg(a.layers, a.embd)
    print(f"device={card_name(dev)} shape={cfg.n_layer}Lx{cfg.n_embd}E "
          f"batch={a.batch} sem_steps={a.sem_steps}", flush=True)
    params = serving_params(cfg, dev)
    bc, bc_cfg = serving_codec(a.tiny_codec, dev)
    launches = Launches()
    stages = profile(cfg, params, bc, bc_cfg, a.batch, a.sem_steps, a.iters,
                     dev)
    sums = report(stages, a.sem_steps)
    out = {"tool": "profile_first_chunk", "device": card_name(dev),
           "L": cfg.n_layer, "C": cfg.n_embd, "batch": a.batch,
           "sem_steps": a.sem_steps, "prefill": PREFILL, "window": WINDOW,
           "iters": a.iters, "quant": "int8",
           "state_dtype": cfg.state_dtype,
           "codec": "tiny" if a.tiny_codec else "full", "stages": stages,
           **sums, "launches": launches.delta()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

"""The tensor-parallel program's structural cost on one card: the port's
counterpart of the JAX package's ``tools/tpu_tp_smoke.py``.

One card has no peer, so this runs the real tensor-parallel program
(``parallel/tp.step_tp``: per-shard weights, the psums, the data-row
plumbing) on a ``(data = 1, model = 1)`` mesh of that card, beside the
plain decode step at the same shapes: a semantic stage (the decode loop
serving runs, ``runtime/engine.semantic_stage``) of ``--steps`` steps with
EOS forbidden, TAG_1 fed first, at ``--batch`` on the raw int8 layout
(``rwkv7.make_serving_params``) with a bf16 state, through the plain step
and then through the TP program's hook. The difference per step is what
the TP program costs over the plain step at tp = 1. ``--tp k`` adds the
same stage on a virtual ``(1, k)`` mesh of the one card: k shards, each
with 1/k of the layer weights, run one after another, and k - 1 psums of
partials a reduction.

Every variant reports ms per step three ways: ``wall_ms`` (CUDA events
around the stage, host launch work included), ``device_ms`` (the summed
CUDA kernel time, ``torch.profiler``, over one decode step through the
same hook: the profiler's post-processing costs about half a millisecond
a kernel, and a virtual tp 2 step launches some 14 000) and ``kernels``
per step. Host walls do not compare between runs or hosts; device time and
kernel counts do.
The WKV launches of each variant (``ops/wkv7.LAUNCHES``) show that every
shard ran the decode kernel. On the CPU (``main(argv, device="cpu")``)
``wall_ms`` is the host clock and the device columns are None.

    python -m rwkv_tts_tpu_torch.tools.tp_smoke [--steps 57] [--batch 8]
        [--tp 2] [--layers 32] [--embd 2048] [--iters 2]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import RwkvConfig
from ..models import rwkv7
from ..parallel import mesh as meshlib
from ..parallel import tp as tplib
from ..runtime.engine import SEMANTIC_SLICE, semantic_stage
from ..utils import threefry
from ..utils.device import resolve_device
from ..utils.timing import device_ms_by_kernel, event_ms
from ._timing import Launches, card_name


def _args(argv):
    p = argparse.ArgumentParser(prog="tp_smoke",
                                description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=57)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--tp", type=int, default=1,
                   help="also run a virtual (1, tp) mesh of the one device")
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--embd", type=int, default=2048)
    p.add_argument("--iters", type=int, default=2)
    return p.parse_args(argv)


def fresh_state(cfg: RwkvConfig, batch: int, device, mesh=None):
    state = rwkv7.init_state(cfg, batch, device=device)
    return state if mesh is None else tplib.shard_state_tp(mesh, state)


def stage_call(params, cfg: RwkvConfig, batch: int, steps: int,
               device: torch.device, step_fn=None, mesh=None):
    """A closure running one semantic stage of ``steps`` steps (EOS
    forbidden) from a fresh state; checks that no slot stopped early."""
    keys = threefry.as_words(np.stack([np.array([0, s], np.uint32)
                                       for s in range(batch)])).to(device)
    limits = torch.full((batch,), steps, dtype=torch.int64, device=device)
    logits0 = torch.zeros((batch, SEMANTIC_SLICE), dtype=torch.float32,
                          device=device)

    def call():
        _, lens, _, _ = semantic_stage(
            params, fresh_state(cfg, batch, device, mesh), logits0, keys,
            limits, limits, cfg, steps, False, feed_tag1=True,
            decode_block=steps, step_fn=step_fn)
        return lens

    lens = call()
    if int(lens.min()) != steps:
        raise RuntimeError(f"a slot stopped before {steps} steps")
    return call


def step_call(params, cfg: RwkvConfig, batch: int, device: torch.device,
              step_fn=None, mesh=None):
    """A closure running one decode step through the same hook."""
    state = fresh_state(cfg, batch, device, mesh)
    tok = torch.zeros((batch,), dtype=torch.int64, device=device)
    if step_fn is None:
        return lambda: rwkv7.step(params, tok, state, cfg,
                                  head_slice=SEMANTIC_SLICE)
    return lambda: step_fn(params, tok, state, SEMANTIC_SLICE)


def wall_ms(call, steps: int, iters: int, device: torch.device) -> float:
    """Wall ms per decode step of ``call`` (``steps`` + TAG_1 steps)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        return (time.perf_counter() - t0) * 1e3 / iters / (steps + 1)
    return event_ms(call, iters, warmup=0) / (steps + 1)


def busy(one_step, device: torch.device) -> Dict[str, Optional[float]]:
    """Device busy ms and kernels of one decode step (None off a card)."""
    if device.type != "cuda":
        return {"device_ms": None, "kernels": None}
    counts: Dict[str, float] = {}
    ms = sum(device_ms_by_kernel(one_step, 1, warmup=1,
                                 counts=counts).values())
    return {"device_ms": ms if ms > 0 else None,
            "kernels": sum(counts.values()) if counts else None}


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    a = _args(argv)
    dev = resolve_device(device)
    cfg = dataclasses.replace(RwkvConfig(), n_layer=a.layers,
                              n_embd=a.embd, state_dtype="bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the raw int8 layout: what the tensor-parallel engine serves
    params = rwkv7.make_serving_params(cfg, gen, fused=False, quant="int8",
                                       device=dev)
    out: Dict = {"device": card_name(dev), "batch": a.batch,
                 "steps": a.steps, "layers": a.layers, "state": "bfloat16",
                 "weights": "int8 raw"}
    variants = [("plain", None)] + [(f"tp{k}", k) for k in sorted({1, a.tp})]
    for name, k in variants:
        run = {}
        if k is not None:
            mesh = meshlib.make_mesh(k, model_parallel=k, devices=[dev] * k)
            run = {"step_fn": tplib.make_step_fn(cfg, mesh), "mesh": mesh}
        sp = params if k is None else tplib.shard_params_tp(mesh, params)
        call = stage_call(sp, cfg, a.batch, a.steps, dev, **run)
        launches = Launches()
        out[name] = {"wall_ms": wall_ms(call, a.steps, a.iters, dev),
                     "wkv7_decode_per_step": launches.delta()["wkv7_decode"]
                     / (a.iters * (a.steps + 1)),
                     **busy(step_call(sp, cfg, a.batch, dev, **run), dev)}
    out["tp11_minus_plain"] = {
        key: (None if out["tp1"][key] is None or out["plain"][key] is None
              else out["tp1"][key] - out["plain"][key])
        for key in ("wall_ms", "device_ms", "kernels")}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

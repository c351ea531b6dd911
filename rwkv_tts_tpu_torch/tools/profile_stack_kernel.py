"""Per-launch overhead of the decode WKV: the port's counterpart of the JAX
package's ``tools/profile_stack_kernel.py``.

A decode step runs the WKV kernel once per layer (L launches). This tool
times, per decode step, three variants on the same inputs:

  serve       L in-place ``wkv7_decode_`` launches, each layer's r
              serialized on the previous layer's y (``r + 0·acc``), as a
              serving step orders them;
  serve_nok   the same harness without the kernel;
  merged      every layer's tiles in ONE launch (``wkv7_decode_layers_``,
              counterpart of the tool's ``merged_step_fn``), legal only
              because these inputs drop the inter-layer dependency, and
              its harness without the kernel (``merged_nok``).

``per_call_overhead_ms`` = (serve − serve_nok) − (merged − merged_nok): what
the L − 1 extra launches cost a step, the share CUDA graphs or a merged
launch could remove. It is given in wall time (CUDA events around the loop,
host launch work included) and in device time (``torch.profiler``); in
eager PyTorch the serving variant's wall is host time, so read per-kernel
figures from the device column. The state floor is the state's read and
write at 3.35 TB/s (H100 SXM).

Defaults: the TPU tool's shape L, H, N, B = 32, 32, 64, 128 with a bf16
state (1.07 GB) and f32 inputs, and the port's serving batch B = 8. The TPU
tool's ``--hb-sweep`` (the Pallas grid's VMEM head-block sizes) has no
counterpart: the CUDA kernel's block is one (b, h) tile and has no block
size to choose.

    python -m rwkv_tts_tpu_torch.tools.profile_stack_kernel [--batch 128 8]
        [--layers 32] [--heads 32] [--steps 16] [--iters 2]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import torch

from ..ops import wkv7 as W
from ..utils.device import resolve_device
from ._timing import Launches, card_name, minus, timed

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
HEAD_SIZE = 64


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_stack_kernel",
                                description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=[128, 8])
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--iters", type=int, default=2)
    return p.parse_args(argv)


def profile_batch(L: int, B: int, H: int, steps: int, iters: int,
                  device: torch.device) -> Dict:
    N, sdt = HEAD_SIZE, torch.bfloat16
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    seq = 0.3 * torch.randn((L, 6, B, H, N), generator=gen, device=device)
    seq[:, 1] = -3.0 * torch.rand((L, B, H, N), generator=gen, device=device)
    state = (0.1 * torch.randn((L, B, H, N, N), generator=gen,
                               device=device)).to(sdt)
    ops = [seq[:, i].contiguous() for i in range(6)]     # [L, B, H, N] each

    def serve(kernel: bool):
        def run():
            acc = torch.zeros((), device=device)
            for _ in range(steps):
                for l in range(L):
                    x = seq[l]
                    r = x[0] + 0.0 * acc
                    y = (W.wkv7_decode_(r, x[1], x[2], x[3], x[4], x[5],
                                        state, l) if kernel else r)
                    acc = y[0, 0, :1].sum()
            return acc
        return run

    def merged(kernel: bool):
        def run():
            acc = torch.zeros((), device=device)
            for _ in range(steps):
                o0 = ops[0] + 0.0 * acc
                y = (W.wkv7_decode_layers_(o0, *ops[1:], state) if kernel
                     else o0)
                acc = y[0, 0, 0, :1].sum()
            return acc
        return run

    variants = {name: timed(fn, iters, device, per=steps) for name, fn in (
        ("serve_nok", serve(False)), ("serve", serve(True)),
        ("merged_nok", merged(False)), ("merged", merged(True)))}
    kernel_serve = minus(variants["serve"], variants["serve_nok"])
    kernel_merged = minus(variants["merged"], variants["merged_nok"])
    state_bytes = 2 * state.numel() * state.element_size()
    input_bytes = 7 * L * B * H * N * 4
    return {"L": L, "B": B, "H": H, "N": N, "state_dtype": str(sdt),
            "state_bytes_per_step": state_bytes,
            "state_floor_ms": state_bytes / HBM_BYTES_PER_S * 1e3,
            "floor_with_inputs_ms": (state_bytes + input_bytes)
            / HBM_BYTES_PER_S * 1e3,
            "variants": variants, "kernel_serve_ms": kernel_serve,
            "kernel_merged_ms": kernel_merged,
            "per_call_overhead_ms": minus(kernel_serve, kernel_merged)}


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    dev = resolve_device(device)
    a = _args(argv)
    launches = Launches()
    out = {"tool": "profile_stack_kernel", "device": card_name(dev),
           "steps": a.steps, "iters": a.iters, "batches": {}}
    for B in a.batch:
        out["batches"][str(B)] = profile_batch(a.layers, B, a.heads, a.steps,
                                               a.iters, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["launches"] = launches.delta()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

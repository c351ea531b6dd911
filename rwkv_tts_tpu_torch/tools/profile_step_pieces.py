"""Decode-step anatomy: each non-GEMM piece of a step timed alone, L layers
deep, as the port's counterpart of the JAX package's
``tools/profile_step_pieces.py``.

Pieces, per decode step at each batch:

  soup       the elementwise and norm chain of a layer (ln1, key shaping,
             sigmoids, l2 norm, v blend, group norm, rk bonus, gate, ln2,
             relu², residuals) on [B, C] operands, L layers;
  lora       the fused LoRA stack [B, 2C] @ [2C, ΣD] → tanh → @ [ΣD, 4C],
             f32, L layers;
  sampler    the semantic sampler as the engine calls it: a threefry draw
             per slot, ``filtered_probs`` (t = 1, p = 0.95, k = 80) and the
             inverse-CDF draw over the 8320-wide head slice;
  wkv_out    the WKV decode step L layers deep OUT OF PLACE
             (``wkv7_decode_out``, row 5's function), the state flowing from
             layer to layer and stacked anew each step, as the JAX layer
             scan's xs/ys do;
  wkv_in     the same IN PLACE on the stack (``wkv7_decode_``). wkv_out −
             wkv_in sizes the extra state round trips that the in-place
             stack kernel exists to save (``models/rwkv7.py:691-693`` of
             the JAX package).

Each piece reports wall (CUDA events around the loop) and device time
(``torch.profiler``) per step. The TPU tool's "transposes" piece has no
counterpart: the port has no batch-in-lanes layout, so no [B, C] ↔
[H, N, B] transposes exist.

    python -m rwkv_tts_tpu_torch.tools.profile_step_pieces [--batch 128 8]
        [--steps 8] [--iters 2] [--layers 32] [--embd 2048]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from ..config import RwkvConfig
from ..ops import wkv7 as W
from ..ops.sampling import filtered_probs, sample_token
from ..runtime.engine import SEMANTIC_SLICE
from ..utils import threefry
from ..utils.device import resolve_device
from ._timing import Launches, card_name, minus, timed


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_step_pieces",
                                description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=[128, 8])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--iters", type=int, default=2)
    p.add_argument("--layers", type=int, default=RwkvConfig.n_layer)
    p.add_argument("--embd", type=int, default=RwkvConfig.n_embd)
    return p.parse_args(argv)


def _ln(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def pieces(cfg: RwkvConfig, B: int, steps: int, iters: int,
           device: torch.device) -> Dict:
    L, Cw, H, N = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.head_size
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=device)

    x0 = randn(B, Cw)

    def renorm(x):
        return x * torch.rsqrt((x * x).mean() + 1.0)

    vecs = randn(L, 10, Cw, scale=0.1)
    rks = randn(L, H, N, scale=0.1)

    def soup():
        x = x0
        for _ in range(steps):
            vf = x * 0.5
            for l in range(L):
                v, rk = vecs[l], rks[l]
                h = _ln(x, v[0], v[1])
                k = h * v[3]
                kk = (h * v[4]).reshape(B, H, N)
                kk = kk * torch.rsqrt((kk * kk).sum(-1, keepdim=True) + 1e-12)
                a = torch.sigmoid(h * v[5])
                k_in = k * (1.0 + (a - 1.0) * v[6])
                vv = h * v[7]
                gate = torch.sigmoid(h * v[8])
                vf = vv + (vf - vv) * gate
                yh = (kk.reshape(B, Cw) + vf).reshape(B, H, N)
                mu = yh.mean(-1, keepdim=True)
                var = yh.var(-1, keepdim=True, correction=0)
                yn = ((yh - mu) * torch.rsqrt(var + 64e-5)).reshape(B, Cw)
                bonus = (k_in.reshape(B, H, N) * rk[None]).sum(-1, keepdim=True)
                x = x + (yn + (bonus * yh).reshape(B, Cw)) * gate
                x = x + torch.relu(_ln(x, v[0], v[1]) * v[9]).square()
            x = renorm(x)
        return x

    D = cfg.decay_lora + cfg.a_lora + cfg.v_lora + cfg.gate_lora
    za = randn(L, 2 * Cw, D, scale=(2 * Cw) ** -0.5)
    zb = randn(L, D, 4 * Cw, scale=D ** -0.5)

    def lora():
        x = x0
        for _ in range(steps):
            for l in range(L):
                u = torch.cat([x, x * 0.5], -1) @ za[l]
                x = x + 0.001 * (torch.tanh(u) @ zb[l])[:, :Cw]
            x = renorm(x)
        return x

    width = min(SEMANTIC_SLICE, cfg.padded_vocab_size)
    logits0 = randn(B, width)
    keys = threefry.as_words(np.stack([threefry.raw_key(s)
                                       for s in range(B)])).to(device)
    sk = C.SEMANTIC_SAMPLING

    def sampler():
        logits = logits0
        for i in range(steps):
            u = threefry.uniform(threefry.fold_in(keys, i))
            tok = sample_token(filtered_probs(logits, sk["temperature"],
                                              sk["top_p"], sk["top_k"]), u)
            logits = logits + tok[:, None].float() * 1e-6
        return logits

    sdt = torch.bfloat16
    rv = randn(L, B, H, N, scale=0.05)
    stack_out = torch.zeros((L, B, H, N, N), dtype=sdt, device=device)
    stack_in = torch.zeros_like(stack_out)

    def wkv_out():
        nonlocal stack_out
        for _ in range(steps):
            new = []
            for l in range(L):
                x = rv[l]
                _, s = W.wkv7_decode_out(x, x, x, x, x, x, stack_out[l])
                new.append(s)
            stack_out = torch.stack(new)
        return stack_out

    def wkv_in():
        for _ in range(steps):
            for l in range(L):
                x = rv[l]
                W.wkv7_decode_(x, x, x, x, x, x, stack_in, l)
        return stack_in

    out = {name: timed(fn, iters, device, per=steps) for name, fn in (
        ("soup", soup), ("lora", lora), ("sampler", sampler),
        ("wkv_out", wkv_out), ("wkv_in", wkv_in))}
    out["wkv_out_minus_in"] = minus(out["wkv_out"], out["wkv_in"])
    slab = B * H * N * N * 2
    out["state_round_trip_ms"] = 2 * L * slab / 3.35e12 * 1e3
    return out


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    dev = resolve_device(device)
    a = _args(argv)
    cfg = RwkvConfig(n_layer=a.layers, n_embd=a.embd)
    launches = Launches()
    out = {"tool": "profile_step_pieces", "device": card_name(dev),
           "L": cfg.n_layer, "C": cfg.n_embd, "steps": a.steps,
           "iters": a.iters, "batches": {}}
    for B in a.batch:
        out["batches"][str(B)] = pieces(cfg, B, a.steps, a.iters, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["launches"] = launches.delta()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
